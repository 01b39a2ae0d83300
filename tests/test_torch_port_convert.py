"""`cli convert` of the port: a reference-format ``.pth`` of each of
families A-E written as a training checkpoint (a train state at step 0
with a fresh optimizer), restored strictly by the trainer (families A-D;
E trains nowhere), read back by ``eval --out`` and ``train --resume``
(family D: the command path is the same for every family, only the
conversion differs), the printed parameter count against `cvad_tpu`'s
import of the same file, and a ``.pth`` of another family refused.

Each ``.pth`` is the port's own state dict of a seeded model at a small
configuration (family A at full width on small frames), saved as the
reference saves one (``{"model_state_dict": ...}``).
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cvad_tpu_torch import cli
from cvad_tpu_torch.config import preset
from cvad_tpu_torch.models.registry import build_model

# family -> (preset, --set overrides): narrow widths, small frames
CONFIGS = {
    "d": ("family_d", ["data.frame_size=16,16", "data.batch_size=2"]),
    "c": ("mini3d", ["data.frame_size=16,16", "data.batch_size=2"]),
    "b": ("memory_ae", ["model.conv_channels=8,16,32,32",
                        "model.latent_dim=16", "model.lstm_hidden=16",
                        "data.clip_len=4", "data.batch_size=2"]),
    "a": ("causal_pipeline", ["data.frame_size=32,48", "data.clip_len=4",
                              "data.batch_size=2"]),
    "e": ("bbox_viz", []),
}
# the port's family-A model holds the GRU's r and z hidden biases (2 x 64)
# that `cvad_tpu` folds into the input ones
A_EXTRA = 128


def _cli(*argv) -> tuple:
    """``cli.main(argv)``: (exit code, the JSON lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]


def _sets(family: str) -> list:
    return [a for s in CONFIGS[family][1] for a in ("--set", s)]


def _pth(family: str, path: Path) -> dict:
    """A seeded model of the family's configuration, saved as the
    reference saves a checkpoint; its state dict."""
    name, sets = CONFIGS[family]
    cfg = cli._apply_overrides(preset(name), sets)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = build_model(cfg.model, **({"in_channels": 1}
                                          if family == "a" else {}))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save({"model_state_dict": state}, path)
    return state


def _jax_params(pth: Path, family: str) -> int:
    """The parameters of `cvad_tpu`'s import of `pth` (its ``convert``'s
    importer; its printed count adds the BatchNorm statistics and family
    B's bank)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from cvad_tpu.runtime import checkpoint as ckpt

    variables = getattr(ckpt, f"import_torch_family_{family}")(str(pth))
    if isinstance(variables, tuple):  # family B: (variables, bank)
        variables = variables[0]
    return sum(int(np.size(x))
               for x in jax.tree_util.tree_leaves(variables["params"]))


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_convert_round_trip(tmp_path, family):
    """`convert` writes the weights strictly loaded (the checkpoint's
    model.pth equal to the .pth entry for entry) beside a fresh optimizer
    at step 0, under RUN/checkpoints; prints the parameter count of
    `cvad_tpu`'s import (family A: 128 above it); the trainer restores it
    strictly with the converted weights and a fresh optimizer at step 0;
    for family D, ``eval --out RUN`` restores it (epoch 0), and ``train
    --resume --epochs 1`` resumes from it."""
    name = CONFIGS[family][0]
    pth, run = tmp_path / "ref.pth", tmp_path / "run"
    state = _pth(family, pth)
    rc, out = _cli("convert", str(pth), "--family", family, "--preset", name,
                   *_sets(family), "--out", str(run))
    assert rc == 0
    written = run / "checkpoints" / "step_00000000" / "model.pth"
    assert out[-1]["out"] == str(written.parent)
    saved = torch.load(written, weights_only=True)
    assert sorted(saved) == ["model_state_dict", "optimizer", "step"]
    assert saved["step"] == 0 and int(saved["optimizer"]["count"]) == 0
    assert sorted(saved["model_state_dict"]) == sorted(state)
    for k, v in state.items():
        assert torch.equal(saved["model_state_dict"][k], v), k
    want = _jax_params(pth, family)
    assert out[-1]["params"] == want + (A_EXTRA if family == "a" else 0)
    if family == "e":  # scores only: no train task reads a run directory
        return

    from cvad_tpu_torch.train.engine import Trainer

    cfg = cli._apply_overrides(preset(name), CONFIGS[family][1])
    tr = Trainer(cfg.replace(train=cfg.train.replace(out_dir=str(run))),
                 device="cpu")
    assert tr.restore() == 0
    assert tr.state.step == 0 and int(tr.state.opt_state.count) == 0
    assert not tr.state.opt_state.mu.any() and not tr.state.opt_state.nu.any()
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(v.cpu(), state[k]), k
    if family != "d":
        return

    rc, out = _cli("eval", "--preset", name, *_sets(family), "--out",
                   str(run), "--n-synthetic", "4", "--device", "cpu")
    assert rc == 0 and out[-1]["epoch"] == 0
    assert (run / "eval_metrics.json").is_file()
    rc, out = _cli("train", "--preset", name, *_sets(family), "--out",
                   str(run), "--resume", "--epochs", "1", "--n-synthetic",
                   "4", "--device", "cpu")
    assert rc == 0 and out[0] == {"resumed_from": 0}
    assert out[-1]["epochs"] == 1 and np.isfinite(out[-1]["final_loss"])


@pytest.mark.parametrize("family,wrong", [("d", "c"), ("c", "b"),
                                          ("b", "a")])
def test_convert_refuses_another_family(tmp_path, family, wrong):
    """A `.pth` converted as another family exits 1 with a JSON error and
    writes no checkpoint."""
    pth = tmp_path / "ref.pth"
    _pth(family, pth)
    rc, out = _cli("convert", str(pth), "--family", wrong, "--preset",
                   CONFIGS[wrong][0], *_sets(wrong), "--out",
                   str(tmp_path / "run"))
    assert rc == 1 and "error" in out[-1]
    assert not (tmp_path / "run").exists()
