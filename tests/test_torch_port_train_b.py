"""Family B's training and serving in the port on the CPU: 1 and 8 train
steps against `cvad_tpu`'s `_family_b_task` from the same weights and
batches (a batch without normal clips among them), the NaN guard, the
BN-absorbed biases, the eval step, `Trainer.fit` with the memory_ae preset
(best by val_loss, reload-best, a bit-identical resume), the service and
the CLI.

The model is the narrow config of tests/test_torch_port_family_b.py.
"""

import functools
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import FamilyBConfig, preset
from cvad_tpu_torch.models import MemoryVideoAutoEncoder
from cvad_tpu_torch.models.family_b import MemoryBankState
from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_b,
                                               from_jax_opt_state)
from cvad_tpu_torch.train.engine import Trainer, make_loaders
from cvad_tpu_torch.train.tasks import (bn_absorbed_biases, build_task,
                                        stop_bn_absorbed_biases)

NARROW = dict(conv_channels=(8, 16, 32, 32), latent_dim=16, lstm_hidden=16,
              memory_size=32)
B, STEPS = 8, 8
NO_NORMAL_STEP = 3  # this step's batch holds anomalous clips only
# the preset's lr is 1e-6; 1e-5 moves each parameter by up to ~8e-5 over
# 8 steps, four times PARAM_ATOL, so the check sees the updates
LR = 1e-5
PARAM_ATOL = 2e-5
ABSORBED = ["encoder.0.bias", "encoder.3.bias", "encoder.6.bias",
            "encoder.9.bias", "decoder.3.bias", "decoder.6.bias",
            "decoder.9.bias"]


def _cfg():
    cfg = preset("memory_ae")
    return cfg.replace(model=FamilyBConfig(**NARROW),
                       optim=cfg.optim.replace(lr=LR))


def _stream():
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (STEPS, B, 8, 64, 64, 1), dtype=np.uint8)
    labels = (rng.uniform(size=(STEPS, B)) < 0.25).astype(np.float32)
    labels[NO_NORMAL_STEP] = 1.0
    return clips, labels


def _jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    return jax


@functools.lru_cache(maxsize=None)
def _jax_task():
    _jax()
    from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig
    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.train.tasks import build_task as jax_build_task

    jcfg = jax_preset("memory_ae")
    return jax_build_task(jcfg.replace(model=JaxFamilyBConfig(**NARROW),
                                       optim=jcfg.optim.replace(lr=LR)))


@pytest.fixture(scope="module")
def jax_run():
    """`cvad_tpu`'s family-B train step over the stream: the initial state,
    the states after steps 1 and STEPS, and every step's metrics."""
    jax = _jax()
    import jax.numpy as jnp

    task = _jax_task()
    clips, labels = _stream()
    state = task.init_state(jax.random.key(0),
                            {"clips": jnp.asarray(clips[0])})
    out = {"init": jax.device_get(state), "metrics": []}
    step = jax.jit(task.train_step)
    with jax.default_matmul_precision("highest"):
        for i in range(STEPS):
            state, m = step(state, {"clips": jnp.asarray(clips[i]),
                                    "labels": jnp.asarray(labels[i])},
                            jax.random.key(1))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i + 1 in (1, STEPS):
                out[i + 1] = jax.device_get(state)
    return out


def _port_state(task, js):
    state = task.init_state(0, "cpu")
    state.model.load_state_dict(from_jax_family_b(
        {"params": js.params, "batch_stats": js.batch_stats}, js.extra),
        strict=True)
    state.opt_state = from_jax_opt_state(js.opt_state, state.model,
                                         convert=from_jax_family_b)
    return state


def _port_batch(clips, labels):
    return {"clips": torch.from_numpy(clips),
            "labels": torch.from_numpy(labels)}


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_step_matches_jax(jax_run, steps):
    """Every step's loss and normal count, then the parameters, the
    BatchNorm running statistics, both Adam moments and the memory bank
    (rows, ptr, fill; the bank wraps at step 6).

    Tolerances: XLA's float32 reductions on the CPU sum naively (about 4e-6
    relative error over the 65,536 values per channel of the first
    BatchNorm, against torch's 1e-7), and BatchNorm's backward cancels most
    of each sum, so the gradients of the first two conv blocks differ by up
    to ~0.2% of their largest entry: Adam's first moment is checked to 5e-3
    and the second to 2e-3 of the largest entry.  Parameters within
    PARAM_ATOL."""
    task = build_task(_cfg())
    state = _port_state(task, jax_run["init"])
    clips, labels = _stream()
    for i in range(steps):
        state, m = task.train_step(state, _port_batch(clips[i], labels[i]), 1)
        ref = jax_run["metrics"][i]
        assert sorted(m) == sorted(ref) == ["loss", "n_normal"]
        assert float(m["n_normal"]) == ref["n_normal"]
        np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-5,
                                   atol=1e-7, err_msg=f"step {i}")
        if i == NO_NORMAL_STEP:
            assert float(m["loss"]) == 0.0 and float(m["n_normal"]) == 0.0
    assert state.step == steps
    js = jax_run[steps]
    want = from_jax_family_b({"params": js.params,
                              "batch_stats": js.batch_stats}, js.extra)
    got = state.model.state_dict()
    init = from_jax_family_b({"params": jax_run["init"].params})
    moved = max(float((want[k] - init[k]).abs().max())
                for k, _ in state.model.named_parameters())
    assert moved > (2 * PARAM_ATOL if steps == STEPS else 0.5 * LR)
    for k, _ in state.model.named_parameters():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(got["normal_memory"].numpy(),
                               want["normal_memory"].numpy(), rtol=0,
                               atol=5e-5)
    assert int(got["memory_ptr"]) == int(want["memory_ptr"])
    assert int(got["memory_fill"]) == int(want["memory_fill"])
    jopt = from_jax_opt_state(js.opt_state, state.model,
                              convert=from_jax_family_b)
    for name, tol in (("mu", 5e-3), ("nu", 2e-3)):
        ours, theirs = getattr(state.opt_state, name), getattr(jopt, name)
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=0,
                                   atol=tol * float(theirs.abs().max()),
                                   err_msg=name)
    assert int(state.opt_state.count) == int(jopt.count) == steps


def test_non_finite_batch_keeps_params_and_adam(jax_run):
    """A NaN clip makes the loss NaN: the parameters and the Adam state stay
    as they were, while the BatchNorm statistics and the memory bank take
    the step's values, NaN included, as in `cvad_tpu`."""
    jax = _jax()
    import jax.numpy as jnp

    clips, labels = _stream()
    bad = clips[0].astype(np.float32) / 255.0
    bad[1, 2, 3, 4, 0] = np.nan
    jtask = _jax_task()
    with jax.default_matmul_precision("highest"):
        js, jm = jax.jit(jtask.train_step)(
            jax.device_put(jax_run["init"]),
            {"clips": jnp.asarray(bad), "labels": jnp.asarray(labels[0])},
            jax.random.key(1))
    js = jax.device_get(js)
    task = build_task(_cfg())
    state = _port_state(task, jax_run["init"])
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    state, m = task.train_step(state, _port_batch(bad, labels[0]), 1)
    assert np.isnan(float(m["loss"])) and np.isnan(float(jm["loss"]))
    for k, v in state.model.named_parameters():
        assert torch.equal(v, before[k]), k
    jopt = from_jax_opt_state(js.opt_state, state.model,
                              convert=from_jax_family_b)
    assert not state.opt_state.mu.any() and not state.opt_state.nu.any()
    assert not jopt.mu.any() and not jopt.nu.any()
    assert int(state.opt_state.count) == int(jopt.count) == 0
    want = from_jax_family_b({"params": js.params,
                              "batch_stats": js.batch_stats}, js.extra)
    got = state.model.state_dict()
    for k in want:
        if "running" in k or k in ("normal_memory", "memory_ptr",
                                   "memory_fill"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=2e-5, err_msg=k)
    assert np.isnan(got["normal_memory"].numpy()).any()
    assert state.step == 1


def test_absorbed_biases_get_exactly_zero_gradient():
    """The conv biases feeding a BatchNorm get 0.0, not autograd's rounding
    noise; the output deconv's bias stays live."""
    task = build_task(_cfg())
    state = task.init_state(0, "cpu")
    model = state.model
    assert bn_absorbed_biases(model) == ABSORBED
    clips, labels = _stream()
    x = torch.from_numpy(clips[0]).float().div(255).permute(0, 1, 4, 2, 3)
    out = model.train().folded_forward(x.reshape(B * 8, 1, 64, 64), None,
                                       t=8)
    loss = ((out["recon_frame"] - x.mean(1)) ** 2).mean()
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     stop_bn_absorbed_biases(model, loss)))
    for name in ABSORBED:
        assert torch.equal(grads[name], torch.zeros_like(grads[name])), name
    assert grads["decoder.12.bias"].abs().item() > 0
    # what autograd would have given them: rounding noise, not 0
    raw = torch.autograd.grad(
        ((model.folded_forward(x.reshape(B * 8, 1, 64, 64), None, t=8)
          ["recon_frame"] - x.mean(1)) ** 2).mean(),
        [dict(model.named_parameters())[n] for n in ABSORBED])
    assert max(g.abs().max().item() for g in raw) < 1e-6


def test_eval_step_matches_jax(jax_run):
    """From the state after STEPS steps (the bank full): the combined score,
    its parts and the per-sample loss, on uint8 clips."""
    jax = _jax()
    import jax.numpy as jnp

    js = jax_run[STEPS]
    clips = np.random.default_rng(5).integers(0, 256, (6, 8, 64, 64, 1),
                                              dtype=np.uint8)
    labels = np.array([0, 1, 0, 0, 1, 0], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(_jax_task().eval_step)(
            jax.device_put(js), {"clips": jnp.asarray(clips),
                                 "labels": jnp.asarray(labels)})
    task = build_task(_cfg())
    got = task.eval_step(_port_state(task, js), _port_batch(clips, labels))
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert float(np.asarray(ref["memory_scores"]).min()) > 0


@pytest.mark.parametrize("case", ["ties", "one_class", "no_normal",
                                  "threshold_default"])
def test_eval_metrics_match_jax(case):
    """The numpy copies of `percentile_threshold`, `binary_metrics` (AUC
    from average ranks; `cvad_tpu` calls scikit-learn) and
    `score_separation` give `cvad_tpu`'s numbers."""
    _jax()
    from cvad_tpu.evaluation import metrics as jm

    from cvad_tpu_torch.evaluation import metrics as pm

    rng = np.random.default_rng(13)
    scores = np.round(rng.uniform(0, 1, 40), 1).astype(np.float32)  # ties
    labels = (rng.uniform(size=40) < 0.3).astype(np.float32)
    if case == "one_class":
        labels[:] = 0.0
    if case == "no_normal":
        labels[:] = 1.0
    thr = (None if case == "threshold_default"
           else jm.percentile_threshold(scores, labels))
    if thr is not None:
        assert pm.percentile_threshold(scores, labels) == thr
    ours = pm.binary_metrics(scores, labels, thr)
    ref = jm.binary_metrics(scores, labels, thr)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12, err_msg=k)
    np.testing.assert_equal(pm.score_separation(scores, labels),
                            jm.score_separation(scores, labels))


@pytest.mark.parametrize("case", ["finite", "inf_target", "nan_target"])
def test_reconstruction_loss_matches_jax(case):
    """The MSE -> L1 -> 0 chain: a target of 3e19 overflows the squared
    error and the L1 takes over; a NaN makes both non-finite and gives 0."""
    _jax()
    import jax.numpy as jnp

    from cvad_tpu.ops.losses import family_b_reconstruction_loss as jax_loss

    from cvad_tpu_torch.ops.losses import family_b_reconstruction_loss

    rng = np.random.default_rng(14)
    pred = rng.uniform(-0.2, 1.2, (3, 4, 5)).astype(np.float32)
    target = rng.uniform(0, 1, (3, 4, 5)).astype(np.float32)
    if case == "inf_target":
        target[0, 0, 0] = 3e19  # squared overflows float32, |.| does not
    if case == "nan_target":
        target[1, 2, 3] = np.nan
    got = float(family_b_reconstruction_loss(torch.from_numpy(pred),
                                             torch.from_numpy(target)))
    ref = float(jax_loss(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.isfinite(got)


# -- trainer, service, CLI ---------------------------------------------------


def _train_cfg(out, epochs):
    cfg = preset("memory_ae")
    return cfg.replace(
        model=FamilyBConfig(**NARROW),
        data=cfg.data.replace(transfer_dtype="uint8"),
        train=cfg.train.replace(num_epochs=epochs, save_interval=1,
                                log_every=10**9, out_dir=str(out)))


def _assert_same_run(a: Trainer, b: Trainer):
    for (k, va), (_, vb) in zip(a.state.model.state_dict().items(),
                                b.state.model.state_dict().items()):
        assert torch.equal(va, vb), k
    for name in ("mu", "nu", "count", "lr"):
        assert torch.equal(getattr(a.state.opt_state, name),
                           getattr(b.state.opt_state, name)), name
    assert a.state.step == b.state.step
    assert a.history.as_dict() == b.history.as_dict()


def test_fit_memory_ae_best_reload_and_resume(tmp_path):
    """`Trainer.fit` with the memory_ae preset (narrowed): eval every epoch,
    the best checkpoint by val_loss (min), the best state reloaded at the
    end, and 2 epochs + restore + epoch 3 bit-identical to 3 epochs: the
    final (reloaded) states and the epoch-3 checkpoints, whose memory bank
    has wrapped (about 22 normal clips an epoch, 32 slots)."""
    cfg = _train_cfg(tmp_path / "a", 3)
    train, evals = make_loaders(cfg, n_synthetic=32)
    full = Trainer(cfg, device="cpu")
    hist = full.fit(train, evals)
    val = [e["val_loss"] for e in hist["evaluation_metrics"]]
    assert len(val) == 3 and all(np.isfinite(val))
    assert full._best == min(val)
    assert {"auc", "f1", "threshold", "separation"} <= set(
        hist["evaluation_metrics"][0])
    best = full.ckpt.restore("best")["model_state_dict"]
    for k, v in full.state.model.state_dict().items():
        assert torch.equal(v, best[k]), k  # reload-best

    first = Trainer(_train_cfg(tmp_path / "b", 2), device="cpu")
    first.fit(train, evals)
    resumed = Trainer(_train_cfg(tmp_path / "b", 3), device="cpu")
    assert resumed.restore() == 2
    resumed.fit(train, evals)
    _assert_same_run(full, resumed)
    a, b = full.ckpt.restore(3), resumed.ckpt.restore(3)
    assert int(a["model_state_dict"]["memory_fill"]) == NARROW["memory_size"]
    for part in ("model_state_dict", "optimizer"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), k


def _full_width_checkpoint(path, fill=300):
    """A full-width model (the service's config) from a seed, with `fill`
    rows of its bank filled, saved as the trainer saves checkpoints."""
    model = MemoryVideoAutoEncoder(seed=3)
    rng = np.random.default_rng(4)
    memory = torch.zeros(500, 64)
    memory[:fill] = torch.from_numpy(rng.normal(size=(fill, 64))
                                     .astype(np.float32))
    model.set_memory_bank(MemoryBankState(
        memory, torch.tensor(fill % 500, dtype=torch.int32),
        torch.tensor(fill, dtype=torch.int32)))
    torch.save({"model_state_dict": model.state_dict(), "step": 0}, path)
    return model


def test_service_from_path_family_b(tmp_path):
    """`service_from_path(..., family='b')` on the CPU answers /healthz and
    /score with the direct scorer's scores and no graphs.  The checkpoint's
    bank has wrapped (ptr 0, fill 500): all 500 rows score."""
    from cvad_tpu_torch.evaluation.http_service import (ScoringHTTPServer,
                                                        service_from_path)
    from cvad_tpu_torch.evaluation.scoring import (make_family_b_score_fn,
                                                   make_score_fn)
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    path = tmp_path / "model.pth"
    _full_width_checkpoint(path, fill=500)
    state = load_torch_state_dict(str(path))
    clips = np.random.default_rng(6).uniform(0, 1, (3, 8, 64, 64, 1)
                                             ).astype(np.float32)
    direct = make_family_b_score_fn(state, device="cpu")(clips)
    assert np.array_equal(make_score_fn("b", state, device="cpu")(clips),
                          direct)
    # `memory` replaces the bank the state dict holds
    bank = (state["normal_memory"].numpy(), np.int32(0), np.int32(500))
    empty = {**state, "memory_fill": torch.zeros(1, dtype=torch.long)}
    assert np.array_equal(make_family_b_score_fn(empty, bank, device="cpu")(
        clips), direct)
    assert not np.array_equal(make_family_b_score_fn(empty, device="cpu")(
        clips), direct)
    model = MemoryVideoAutoEncoder()
    model.load_state_dict(state)
    assert int(model.memory_bank().fill) == 500
    svc = service_from_path(str(path), family="b", buckets=(1, 4),
                            device="cpu")
    assert svc.clip_shape == (8, 64, 64, 1)
    srv = ScoringHTTPServer(svc, port=0)
    host, port = srv.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read())["clip_shape"] == [8, 64, 64, 1]
        buf = io.BytesIO()
        np.savez(buf, clips=clips)
        req = urllib.request.Request(
            f"http://{host}:{port}/score", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            rep = json.loads(r.read())
    finally:
        srv.close()
    assert rep["n"] == 3 and rep["graphs"] is None
    np.testing.assert_allclose(rep["scores"], direct, rtol=0, atol=1e-6)


def test_cli_train_and_serve_family_b(tmp_path, monkeypatch, capsys):
    """``train --preset memory_ae`` (narrowed with --set) writes a best
    checkpoint; ``serve --family b`` builds the family-B service over a
    checkpoint, warms it up and returns when the server stops."""
    from cvad_tpu_torch import cli
    from cvad_tpu_torch.evaluation import http_service

    out = tmp_path / "run"
    assert cli.main(["train", "--preset", "memory_ae", "--epochs", "1",
                     "--n-synthetic", "8", "--set", "data.batch_size=4",
                     "--set", "model.conv_channels=8,16,32,32",
                     "--set", "model.latent_dim=16",
                     "--set", "model.lstm_hidden=16",
                     "--set", "model.memory_size=32",
                     "--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["epochs"] == 1 and np.isfinite(res["final_loss"])
    assert json.loads((out / "config.json").read_text())["model"][
        "name"] == "family_b"
    assert (out / "checkpoints" / "best" / "model.pth").is_file()

    seen = {}
    serve_forever = http_service.ScoringHTTPServer.serve_forever

    def serve_briefly(self):
        seen["clip_shape"] = self.service.clip_shape
        threading.Timer(0.2, self._httpd.shutdown).start()
        serve_forever(self)

    monkeypatch.setattr(http_service.ScoringHTTPServer, "serve_forever",
                        serve_briefly)
    path = tmp_path / "full.pth"
    _full_width_checkpoint(path)
    assert cli.main(["serve", str(path), "--family", "b", "--device", "cpu",
                     "--port", "0", "--buckets", "1,2", "--warmup"]) == 0
    assert seen["clip_shape"] == (8, 64, 64, 1)
