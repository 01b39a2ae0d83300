"""The port's trainer on the CPU: synthetic data and batch order
bit-identical to `cvad_tpu`'s, the history schema, resume (at an epoch
boundary and mid-epoch) bit-identical to an uninterrupted run, the
checkpoint manager, a trained checkpoint that scores, and the CLI.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import preset
from cvad_tpu_torch.data.batcher import BatchLoader
from cvad_tpu_torch.data.datasets import SyntheticClipDataset, build_dataset
from cvad_tpu_torch.data.synthetic import make_synthetic_clips
from cvad_tpu_torch.runtime.checkpoint import CheckpointManager
from cvad_tpu_torch.runtime.history import TrainingHistory
from cvad_tpu_torch.train.engine import Trainer, make_loaders

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(out, epochs, **train):
    cfg = preset("family_d")
    return cfg.replace(
        data=cfg.data.replace(batch_size=4, frame_size=(16, 16),
                              transfer_dtype="uint8"),
        train=cfg.train.replace(num_epochs=epochs, eval_every=10**9,
                                save_interval=1, log_every=10**9,
                                out_dir=str(out), **train))


def _assert_same_run(a: Trainer, b: Trainer):
    for (k, va), (_, vb) in zip(a.state.model.state_dict().items(),
                                b.state.model.state_dict().items()):
        assert torch.equal(va, vb), k
    for name in ("mu", "nu", "count", "lr"):
        assert torch.equal(getattr(a.state.opt_state, name),
                           getattr(b.state.opt_state, name)), name
    assert a.state.step == b.state.step
    assert a.history.as_dict() == b.history.as_dict()


# -- data --------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["easy", "hard"])
def test_synthetic_clips_bit_identical_to_jax(profile):
    pytest.importorskip("flax")
    from cvad_tpu.data.synthetic import make_synthetic_clips as jax_make

    got = make_synthetic_clips(6, 8, (16, 12), 3, 0.5, seed=3,
                               profile=profile)
    ref = jax_make(6, 8, (16, 12), 3, 0.5, seed=3, profile=profile)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def test_batch_order_bit_identical_to_jax():
    """The same shuffle per epoch, `iter_from`, `sample_batch` and the
    uint8 transfer, batch for batch."""
    pytest.importorskip("flax")
    from cvad_tpu.config import DataConfig as JaxDataConfig
    from cvad_tpu.data.batcher import BatchLoader as JaxLoader
    from cvad_tpu.data.datasets import SyntheticClipDataset as JaxDataset

    cfg = preset("family_d").data.replace(frame_size=(8, 8), seed=5)
    jcfg = JaxDataConfig(frame_size=(8, 8), seed=5)
    ours = BatchLoader(SyntheticClipDataset(cfg, 10), 3, shuffle=True,
                       seed=5, transfer_dtype="uint8")
    ref = JaxLoader(JaxDataset(jcfg, 10), 3, shuffle=True, seed=5,
                    transfer_dtype="uint8")

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])

    same(ours.sample_batch(), ref.sample_batch())
    for epoch in (1, 2, 7):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours) == 4
        for a, b in zip(got, want):
            same(a, b)
        assert got[0]["clips"].dtype == np.uint8
    ours.set_epoch(2)
    ref.set_epoch(2)
    for a, b in zip(ours.iter_from(2), ref.iter_from(2)):
        same(a, b)


def test_history_keys_match_jax():
    pytest.importorskip("flax")
    from cvad_tpu.runtime.history import TrainingHistory as JaxHistory

    assert TrainingHistory.KEYS == JaxHistory.KEYS


def test_state_is_the_shipped_model():
    """The trainer's model is the shipped width, and its state dict is the
    reference's (the fixture .pth loads into it, strict)."""
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.train.state import float_metrics, param_count
    from cvad_tpu_torch.train.tasks import build_task

    state = build_task(preset("family_d")).init_state(0, "cpu")
    assert param_count(state.model) == 188849
    state.model.load_state_dict(load_torch_state_dict(os.path.join(
        ROOT, "runs/dyn_parity_d/ours/best_improved_model.pth")), strict=True)
    assert float_metrics({"a": torch.tensor(0.5)}) == {"a": 0.5}


def test_build_dataset_refuses_folder_datasets():
    """The folder datasets are ported (tests/test_torch_port_data.py): a
    root that holds no tree is refused, and so is an unknown dataset."""
    data = preset("family_d").data
    for name in ("avenue", "ucsd_ped2", "ucsd_ped2_simple"):
        with pytest.raises(FileNotFoundError):
            build_dataset(data.replace(dataset=name, root="/nonexistent"))
    with pytest.raises(KeyError):
        build_dataset(data.replace(dataset="nope"))


def test_unported_knobs_raise(tmp_path):
    """K steps per call and the device cache are ported
    (tests/test_torch_port_steps.py, tests/test_torch_port_cache.py): a
    K below 1, an unknown cache mode and a memory share outside (0, 1]
    raise; ``Trainer`` takes K > 1 and 'on'.  The bbox_viz preset (ROADMAP
    Queue 1 item 11) is still refused."""
    for train, what in ((dict(steps_per_call=0), "steps_per_call"),
                        (dict(device_cache="always"), "device_cache"),
                        (dict(device_cache_hbm_frac=0.0), "hbm_frac"),
                        (dict(device_cache_hbm_frac=1.5), "hbm_frac")):
        with pytest.raises(ValueError, match=what):
            Trainer(_cfg(tmp_path, 1, **train), device="cpu")
    trainer = Trainer(_cfg(tmp_path, 1, steps_per_call=2, device_cache="on"),
                      device="cpu")
    assert trainer.cfg.train.steps_per_call == 2
    with pytest.raises(NotImplementedError, match="item 11"):
        preset("bbox_viz")


# -- resume ------------------------------------------------------------------


def test_epoch_resume_bit_identical(tmp_path):
    """2 epochs, a new trainer restored from the epoch-2 checkpoint, then
    epochs 3-4: bit-identical to 4 epochs in one run."""
    cfg = _cfg(tmp_path / "a", 4)
    loader, _ = make_loaders(cfg, n_synthetic=12)
    full = Trainer(cfg, device="cpu")
    full.fit(loader)

    cfg2 = _cfg(tmp_path / "b", 2)
    first = Trainer(cfg2, device="cpu")
    first.fit(loader)
    resumed = Trainer(_cfg(tmp_path / "b", 4), device="cpu")
    assert resumed.restore() == 2
    assert resumed.history.last_epoch == 2
    hist = resumed.fit(loader)
    assert hist["epochs"] == [1, 2, 3, 4]
    _assert_same_run(full, resumed)


class _Interrupted(Exception):
    pass


class _InterruptingLoader:
    """Passes `left` batches through, then raises, as a preemption."""

    def __init__(self, inner, left):
        self.inner, self.left = inner, left

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def __iter__(self):
        for b in self.inner:
            if self.left <= 0:
                raise _Interrupted()
            self.left -= 1
            yield b


def test_midepoch_resume_bit_identical(tmp_path):
    """`save_every_steps`: a run that dies mid-epoch and resumes from the
    rolling 'mid' checkpoint ends bit-identical to the uninterrupted one,
    as tests/test_resume.py checks for `cvad_tpu`."""
    cfg_a = _cfg(tmp_path / "a", 2)
    loader, _ = make_loaders(cfg_a, n_synthetic=24)  # 6 batches an epoch
    full = Trainer(cfg_a, device="cpu")
    full.fit(loader)

    cfg_b = _cfg(tmp_path / "b", 2, save_every_steps=2)
    with pytest.raises(_Interrupted):
        # dies pulling epoch 2's 4th batch; the last 'mid' save was at 2
        Trainer(cfg_b, device="cpu").fit(_InterruptingLoader(loader, 9))
    resumed = Trainer(cfg_b, device="cpu")
    assert resumed.restore() is not None
    assert int(resumed._mid_resume["epoch"]) == 2
    assert int(resumed._mid_resume["count"]) == 2
    resumed.fit(loader)
    _assert_same_run(full, resumed)
    assert not (tmp_path / "b" / "checkpoints" / "mid").exists()


# -- checkpoints ---------------------------------------------------------------


def test_checkpoint_gc_and_atomic_overwrite(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(1, 5):
        mgr.save(step, {"step": step}, history={"epochs": [step]})
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4
    assert mgr.restore(4)["step"] == 4

    mgr.save("mid", {"step": 1}, history={"v": 1})
    # a crash left a half-written new copy and an old copy: the next save
    # clears both and swaps in a whole one
    (tmp_path / "_tmp.mid").mkdir()
    (tmp_path / "_old.mid").mkdir()
    mgr.save("mid", {"step": 2}, history={"v": 2})
    assert mgr.restore("mid")["step"] == 2
    assert mgr.restore_history("mid") == {"v": 2}
    assert not any(p.name.startswith(("_tmp.", "_old."))
                   for p in tmp_path.iterdir())
    assert mgr.latest_step() == 4  # 'mid' and 'best' are not steps
    mgr.remove("mid")
    assert not (tmp_path / "mid").exists()


def test_best_checkpoint_scores(tmp_path):
    """The `best` checkpoint is a reference-format .pth: the scorer loads it
    and its scores equal the trainer's eval step on the same clips."""
    from cvad_tpu_torch.evaluation.scoring import make_family_d_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    cfg = _cfg(tmp_path, 2).replace(train=_cfg(tmp_path, 2).train.replace(
        eval_every=1))
    train, evals = make_loaders(cfg, n_synthetic=8)
    tr = Trainer(cfg, device="cpu")
    tr.fit(train, evals)
    best = tr.ckpt.path("best")
    assert best.is_file()
    restored = Trainer(cfg, out_dir=str(tmp_path / "r"), device="cpu")
    restored.init_state()
    restored.state.load_state_dict(tr.ckpt.restore("best"))
    clips = evals.sample_batch()["clips"]
    want = restored.task.eval_step(restored.state,
                                   restored.put_batch({"clips": clips}))
    scores, adj = make_family_d_score_fn(load_torch_state_dict(str(best)),
                                         device="cpu")(clips)
    np.testing.assert_allclose(scores, want["predictions"].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(adj, want["causal_graphs"].numpy(), atol=1e-5)


def test_cli_train_runs(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "cvad_tpu_torch.cli", "train", "--epochs", "1",
         "--n-synthetic", "8", "--set", "data.batch_size=4", "--device",
         "cpu", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["epochs"] == 1 and np.isfinite(res["final_loss"])
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["data"]["batch_size"] == 4
    hist = json.loads((tmp_path / "improved_training_history.json")
                      .read_text())
    assert set(hist) == set(TrainingHistory.KEYS)
    assert os.path.isfile(res["best"])
