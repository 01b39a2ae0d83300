"""The PyTorch port imports without JAX and loads nothing of `cvad_tpu`
(every module, families C, A and E, the device clip cache, the K-step
graphs, the localization and report modules, the plots, the diagnosis,
the doctor, the mesh, the multi-process helpers and the collectives
included); its entry points default to CUDA and raise
without it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None          # any import of them raises
import cvad_tpu_torch
mods = ["cvad_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(cvad_tpu_torch.__path__,
                                          "cvad_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
loaded = [m for m in sys.modules if sys.modules[m] is not None]
print(json.dumps({"imported": mods, "loaded": loaded}))
"""


def test_imports_without_jax_or_cvad_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("cvad_tpu_torch.cli", "cvad_tpu_torch.config",
                "cvad_tpu_torch.ops.pallas_conv",
                "cvad_tpu_torch.ops.pallas_kernels",
                "cvad_tpu_torch.ops.pallas_s2d",
                "cvad_tpu_torch.ops.attention",
                "cvad_tpu_torch.ops.flash_attention",
                "cvad_tpu_torch.ops.losses", "cvad_tpu_torch.ops.adjacency",
                "cvad_tpu_torch.models.family_d",
                "cvad_tpu_torch.models.family_b",
                "cvad_tpu_torch.models.family_c",
                "cvad_tpu_torch.models.family_a",
                "cvad_tpu_torch.models.family_e",
                "cvad_tpu_torch.evaluation.block_correlation",
                "cvad_tpu_torch.evaluation.bbox",
                "cvad_tpu_torch.evaluation.detectors",
                "cvad_tpu_torch.evaluation.plots",
                "cvad_tpu_torch.utils.diagnose",
                "cvad_tpu_torch.runtime.doctor",
                "cvad_tpu_torch.models.init", "cvad_tpu_torch.models.layers",
                "cvad_tpu_torch.evaluation.scoring",
                "cvad_tpu_torch.evaluation.serving",
                "cvad_tpu_torch.evaluation.http_service",
                "cvad_tpu_torch.evaluation.metrics",
                "cvad_tpu_torch.runtime.checkpoint",
                "cvad_tpu_torch.runtime.history",
                "cvad_tpu_torch.runtime.metrics",
                "cvad_tpu_torch.utils.json_utils",
                "cvad_tpu_torch.data.synthetic",
                "cvad_tpu_torch.data.datasets",
                "cvad_tpu_torch.data.batcher",
                "cvad_tpu_torch.data.device_cache",
                "cvad_tpu_torch.data.frames",
                "cvad_tpu_torch.data.labels",
                "cvad_tpu_torch.data.ground_truth",
                "cvad_tpu_torch.data.native_decoder",
                "cvad_tpu_torch.data.decode",
                "cvad_tpu_torch.evaluation.streaming",
                "cvad_tpu_torch.evaluation.frame_auc",
                "cvad_tpu_torch.train.optim", "cvad_tpu_torch.train.state",
                "cvad_tpu_torch.train.tasks", "cvad_tpu_torch.train.engine",
                "cvad_tpu_torch.train.graphs",
                "cvad_tpu_torch.runtime.device",
                "cvad_tpu_torch.runtime.mesh",
                "cvad_tpu_torch.runtime.multihost",
                "cvad_tpu_torch.parallel",
                "cvad_tpu_torch.parallel.collectives",
                "cvad_tpu_torch.parallel.temporal",
                "cvad_tpu_torch.parallel.dryrun"):
        assert mod in res["imported"]
    bad = [m for m in res["loaded"]
           if m.split(".")[0] in ("cvad_tpu", "jax", "jaxlib", "flax",
                                  "optax")]
    assert bad == []


def test_resolve_device():
    from cvad_tpu_torch.runtime.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_entry_points_default_to_cuda(tmp_path):
    """Without a card, every entry point raises unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default is satisfiable")
    from cvad_tpu_torch.cli import main
    from cvad_tpu_torch.evaluation.scoring import (
        make_family_d_bulk_score_fn, make_family_d_score_fn)
    from cvad_tpu_torch.models import CausalAnomalyDetector

    state = CausalAnomalyDetector().state_dict()
    with pytest.raises(RuntimeError):
        make_family_d_score_fn(state)
    with pytest.raises(RuntimeError):
        make_family_d_bulk_score_fn(state)
    ckpt = os.path.join(ROOT, "runs/dyn_parity_d/ours/best_improved_model.pth")
    with pytest.raises(RuntimeError):
        main(["serve", ckpt, "--port", "0"])
    from cvad_tpu_torch.config import preset
    from cvad_tpu_torch.train.engine import Trainer

    from cvad_tpu_torch.train.tasks import build_task

    with pytest.raises(RuntimeError):
        Trainer(preset("family_d"), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        build_task(preset("family_d")).init_state(0)
    with pytest.raises(RuntimeError):
        main(["train", "--epochs", "1", "--n-synthetic", "8",
              "--out", str(tmp_path / "cli")])
    # family B: the scorer, the service, the trainer, the task, the CLI
    from cvad_tpu_torch.evaluation.scoring import (make_family_b_score_fn,
                                                   make_score_fn)
    from cvad_tpu_torch.models import MemoryVideoAutoEncoder

    state_b = MemoryVideoAutoEncoder().state_dict()
    with pytest.raises(RuntimeError):
        make_family_b_score_fn(state_b)
    with pytest.raises(RuntimeError):
        make_score_fn("b", state_b)
    ckpt_b = str(tmp_path / "b.pth")
    torch.save({"model_state_dict": state_b}, ckpt_b)
    with pytest.raises(RuntimeError):
        main(["serve", ckpt_b, "--family", "b", "--port", "0"])
    with pytest.raises(RuntimeError):
        Trainer(preset("memory_ae"), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        build_task(preset("memory_ae")).init_state(0)
    with pytest.raises(RuntimeError):
        main(["train", "--preset", "memory_ae", "--epochs", "1",
              "--n-synthetic", "8", "--out", str(tmp_path / "cli_b")])
    # families C and A: the scorers, the trainer, the tasks, the CLI
    from cvad_tpu_torch.evaluation.block_correlation import \
        block_channel_correlations
    from cvad_tpu_torch.models import (CausalPipelineDetector,
                                       Simple3DCNNDetector)

    state_c = Simple3DCNNDetector().state_dict()
    state_a = CausalPipelineDetector().state_dict()
    for fam, st in (("c", state_c), ("a", state_a)):
        with pytest.raises(RuntimeError):
            make_score_fn(fam, st)
    with pytest.raises(RuntimeError):
        block_channel_correlations(state_c, np.zeros((1, 8, 64, 64, 1)))
    for name in ("mini3d", "causal_pipeline", "causal_pipeline_v0"):
        with pytest.raises(RuntimeError):
            Trainer(preset(name), out_dir=str(tmp_path))
        with pytest.raises(RuntimeError):
            build_task(preset(name)).init_state(0)
        with pytest.raises(RuntimeError):
            main(["train", "--preset", name, "--epochs", "1",
                  "--n-synthetic", "8", "--out", str(tmp_path / name)])
    # family E, the report and the smoke gate
    from cvad_tpu_torch.models import BBoxVizDetector

    with pytest.raises(RuntimeError):
        make_score_fn("e", BBoxVizDetector().state_dict())
    with pytest.raises(RuntimeError):
        main(["report", str(tmp_path), "--checkpoint", ckpt])
    with pytest.raises(RuntimeError):
        main(["smoke"])
    # family B with the attention encoder
    from cvad_tpu_torch.config import FamilyBConfig

    attn = FamilyBConfig(temporal_encoder="attention", latent_dim=32,
                         attn_heads=2, attn_layers=1)
    with pytest.raises(RuntimeError):
        make_family_b_score_fn(MemoryVideoAutoEncoder(attn).state_dict(),
                               cfg=attn)
