"""Each frozen reference against the port's model at a small size on the
CPU, from the benchmark's seeded weights: the eval forward, and the first
train steps with the trainer's step seeds (the tests may import both; the
references import nothing of the port)."""

import copy

import numpy as np
import pytest
import torch

from portbench import data, harness
from portbench.drivers import train as drv
from portbench.tests.small import small_cell

CPU = torch.device("cpu")


def test_references_import_nothing_of_the_port():
    for name in ("family_d", "family_a"):
        src = (harness.BENCH / "reference" / f"{name}.py").read_text()
        assert "cvad_tpu" not in src and "jax" not in src


@pytest.mark.parametrize("name", ["train-d-b256", "train-a-b4-k4"])
def test_train_steps_match_the_trainer(name, tmp_path):
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.train.engine import Trainer

    cell = small_cell(name)
    cfg_file, traffic = cell["config"], cell["traffic"]
    traffic["steps_per_call"] = 1
    ref = harness.reference(cfg_file["reference"])
    seed, b = 2 ** 31 + 7, traffic["batch"]
    cfg = drv.experiment_config(cfg_file, traffic, seed)
    d = cfg_file["data"]
    clips, labels = data.seeded_clips(
        torch, 3 * b, (d["clip_len"], *d["frame_size"], d["channels"]), 0.3,
        seed, CPU)
    rows = np.arange(3 * b).reshape(3, b)
    fixed = {-(i + 1): [r] for i, r in enumerate(rows)}
    loader = data.seeded_loader(BatchLoader, data.ArrayClips(clips, labels),
                                b, seed, fixed)
    weights = ref.make_weights(cfg_file, seed, CPU)
    trainer = Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    trainer.init_state()
    trainer.state.model.load_state_dict(weights)
    names = [n for n, q in trainer.state.model.named_parameters()
             if q.requires_grad]
    prog = {**drv.checked_calls(trainer, loader, 1, names),
            "params0": {n: weights[n].clone() for n in names}}
    out = ref.train_steps(cfg_file, copy.deepcopy(weights),
                          [torch.from_numpy(clips[r]) for r in rows],
                          [torch.from_numpy(labels[r]) for r in rows],
                          cfg.train.seed + 1, CPU, drv.calls(1))
    gaps = drv.compare(prog, out, 1, cfg.optim.b1)
    # the measures of a run's check, far inside its limits on the CPU
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3 and gaps["lr_gap"] < 1e-6


def test_family_a_scores_match_the_scorer():
    from cvad_tpu_torch.config import FamilyAConfig
    from cvad_tpu_torch.evaluation.scoring import make_score_fn

    cell = small_cell("serve-a-cameras")
    cfg = cell["config"]
    ref = harness.reference("family_a")
    weights = ref.make_weights(cfg, 11, CPU)
    d = cfg["data"]
    clips, _ = data.seeded_clips(torch, 6, (d["clip_len"], *d["frame_size"],
                                            d["channels"]), 0.0, 11, CPU)
    model_cfg = FamilyAConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg["model"].items()})
    fn = make_score_fn("a", weights, cfg=model_cfg, device="cpu")
    np.testing.assert_allclose(
        fn(clips), ref.scores(cfg, weights, torch.from_numpy(clips), CPU)
        .numpy(), rtol=1e-5, atol=1e-6)
