"""Family A's training in the port against `cvad_tpu` on the CPU: 1 and 3
train steps of the causal_pipeline preset from the same weights (the frozen
stem unchanged, the BN-absorbed biases with exactly zero gradient), one
step of the anchor preset, the remat step equal to the plain one, the
bf16 step, and `Trainer.fit` with eval, a resume and the CLI.

The model is tests/test_torch_port_family_a.py's: full width on 2 clips of
4 frames of 32x48, its `mixed` detector so that boxes, trajectories and
the adjacency vary (and carry gradient).  The frameworks cannot share
random draws: dropout is off on both sides (`cvad_tpu`'s
``flax.linen.Dropout`` patched to return its input, the port's
``nn.Dropout`` at ``p = 0``), and the port's VAE draw is `cvad_tpu`'s own,
``jax.random.normal`` of the first half of ``split(fold_in(key, step))``
(`cvad_tpu/train/tasks.py:429-430`), put into `family_a.vae_noise`.  Each
step's train-mode detections are held to the margins of the forward tests
first.

Tolerances.  Adam moves a parameter by about lr * sign(g) in its first
steps: where a gradient entry is within rounding of 0, the frameworks'
float sums (in other orders) can give it another sign.  After 1 step the
parameters whose gradient is above TINY_G are held to PARAM_ATOL (7% of
lr = 3e-4), the others to 2 lr, and they must be a small share; after 3
steps, where such differences have moved the forward a little, every
parameter within 2 lr and 99.5% within PARAM_ATOL.
"""

import copy
import functools
import json

import numpy as np
import pytest
import torch

import cvad_tpu_torch.models.family_a as family_a
from cvad_tpu_torch.config import preset
from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_a,
                                               to_jax_family_a)
from cvad_tpu_torch.train.engine import Trainer, make_loaders
from cvad_tpu_torch.train.tasks import bn_absorbed_biases, build_task
from test_torch_port_family_a import (B, H, T, W, anchor_conf_margin,
                                      assert_margins, clips, frames, model)

STEPS = 3
PARAM_ATOL = 2e-5
TINY_G = 1e-7
STEM = ["backbone.conv1.weight", "backbone.conv1.bias",
        "backbone.bn1.weight", "backbone.bn1.bias"]
ABSORBED = [f"backbone.layer{n}.{i}.bias" for n in range(1, 5)
            for i in (0, 3)]


def _jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    return jax


def _cfg(name="causal_pipeline", **train):
    cfg = preset(name)
    return cfg.replace(data=cfg.data.replace(frame_size=(H, W), clip_len=T,
                                             batch_size=B),
                       train=cfg.train.replace(**train))


def _stream(seed=20):
    x = np.stack([clips(seed + i) for i in range(STEPS)])
    u8 = (x * 255).round().astype(np.uint8)
    labels = np.array([[0, 1], [1, 0], [1, 1]], np.float32)
    return u8, labels


def _noise(step: int, shape) -> np.ndarray:
    """`cvad_tpu`'s VAE draw at `step` of a run keyed with key(1)."""
    jax = _jax()
    r_vae, _ = jax.random.split(jax.random.fold_in(jax.random.key(1), step))
    return np.array(jax.random.normal(r_vae, shape))


class JaxNoise:
    """`family_a.vae_noise` replaced by `cvad_tpu`'s draw of step
    ``self.step``."""

    def __init__(self, monkeypatch):
        self.step = 0
        monkeypatch.setattr(family_a, "vae_noise", self)

    def __call__(self, shape, dtype, device, generator):
        return torch.from_numpy(_noise(self.step, shape)).to(device, dtype)


def _init_state(name):
    """The port's seed-1 model as a state dict (the mixed detector where
    the preset has the masked one)."""
    cfg = preset(name).model
    return model(cfg, seed=1, mixed=not cfg.anchor_variant).state_dict()


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, steps: int):
    """`cvad_tpu`'s family-A step of preset `name` over the stream from the
    port's weights, dropout patched out: each step's metrics and the
    state dicts after each step."""
    jax = _jax()
    import flax.linen as fnn
    import jax.numpy as jnp
    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.train.state import make_state
    from cvad_tpu.train.tasks import build_task as jax_build_task

    jcfg = jax_preset(name)
    task = jax_build_task(jcfg.replace(data=jcfg.data.replace(
        frame_size=(H, W), clip_len=T, batch_size=B)))
    cfg = preset(name).model
    v = to_jax_family_a(_init_state(name), cfg)
    state = make_state(v["params"], task.tx, batch_stats=v["batch_stats"])
    u8, labels = _stream()
    out = {"metrics": [], "states": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        step = jax.jit(task.train_step)
        with jax.default_matmul_precision("highest"):
            for i in range(steps):
                state, m = step(state, {"clips": jnp.asarray(u8[i]),
                                        "labels": jnp.asarray(labels[i])},
                                jax.random.key(1))
                out["metrics"].append({k: float(v) for k, v in m.items()})
                out["states"].append(from_jax_family_a(jax.device_get(
                    {"params": state.params,
                     "batch_stats": state.batch_stats}), cfg))
    return out


def _port_run(name, steps, monkeypatch, **model_kw):
    """The port's steps over the same stream from the same weights; each
    step's train-mode detections checked for their margins first.
    Returns the state, the metrics and each step's gradient (from Adam's
    first moment)."""
    cfg = _cfg(name)
    cfg = cfg.replace(model=cfg.model.replace(**model_kw))
    task = build_task(cfg)
    state = task.init_state(0, "cpu")
    state.model.load_state_dict(_init_state(name), strict=True)
    model_dropout_off(state.model)
    noise = JaxNoise(monkeypatch)
    u8, labels = _stream()
    metrics, grads = [], []
    for i in range(steps):
        noise.step = i
        probe = copy.deepcopy(state.model).train()
        x = frames(u8[i].astype(np.float32) / 255.0)
        with torch.no_grad():
            assert_margins(probe(x))
        if cfg.model.anchor_variant:
            assert anchor_conf_margin(probe, x) > 1e-5
        mu = state.opt_state.mu.clone()
        state, m = task.train_step(state, {
            "clips": torch.from_numpy(u8[i]),
            "labels": torch.from_numpy(labels[i])}, 1)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append((state.opt_state.mu - 0.9 * mu) / 0.1)
    return state, metrics, grads


def model_dropout_off(m):
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0


def _check_params(state, want, grad, steps, lr):
    named = [(n, p) for n, p in state.model.named_parameters()
             if p.requires_grad]
    sizes = [p.numel() for _, p in named]
    far = total = 0
    for (name, p), g in zip(named, grad.split(sizes)):
        d = (p.detach() - want[name]).abs().reshape(-1)
        assert float(d.max()) <= 2 * lr, name
        if steps == 1:
            small = g.abs() <= TINY_G
            assert float(torch.where(small, 0.0, d).max()) <= PARAM_ATOL, \
                name
        far += int((d > PARAM_ATOL).sum())
        total += d.numel()
    assert far <= (1e-4 if steps == 1 else 5e-3) * total, (far, total)


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_steps_match_jax(steps, monkeypatch):
    """Every step's loss and terms (rtol 1e-5 at step 1, 2e-4 after it);
    the parameters by the module's rule; the BatchNorm statistics within
    1e-5 relative and 1e-6 absolute after 1 step, 1% of each leaf's
    largest entry after 3; the stem's parameters exactly as they were on
    both sides (bn1's running statistics moved), out of the optimizer's
    vector; the BN-absorbed biases exactly 0 on both sides."""
    ref = _jax_run("causal_pipeline", STEPS)
    state, metrics, grads = _port_run("causal_pipeline", steps, monkeypatch)
    for i, (got, want) in enumerate(zip(metrics, ref["metrics"])):
        assert sorted(got) == sorted(want) == ["causal_mse", "ce", "kl",
                                               "loss", "score_mse"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=1e-5 if i == 0 else 2e-4,
                                       err_msg=f"step {i} {k}")
    want = ref["states"][steps - 1]
    init = _init_state("causal_pipeline")
    _check_params(state, want, grads[-1], steps, preset(
        "causal_pipeline").optim.lr)
    got = state.model.state_dict()
    for k in want:
        if "running" in k:
            w = want[k].numpy()
            rtol, atol = ((1e-5, 1e-6) if steps == 1
                          else (0.0, 1e-2 * float(np.abs(w).max())))
            np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                       atol=atol, err_msg=k)
    for k in STEM:
        assert torch.equal(got[k], init[k]) and torch.equal(want[k], init[k])
        assert not state.model.get_parameter(k).requires_grad
    assert not torch.equal(got["backbone.bn1.running_mean"],
                           init["backbone.bn1.running_mean"])
    n_trainable = sum(p.numel() for p in state.params())
    assert state.opt_state.mu.numel() == n_trainable == sum(
        p.numel() for p in state.model.parameters()) - 32 * 49 - 3 * 32
    assert bn_absorbed_biases(state.model) == ABSORBED
    for k in ABSORBED:
        assert not got[k].any() and not want[k].any(), k
    assert int(state.opt_state.count) == steps


def test_anchor_step_matches_jax(monkeypatch):
    """One step of causal_pipeline_v0 (the anchor detector, one score head,
    no direct classifier; its preset's loss: MSE + 0.001 KL, CE 0): the
    metrics within rtol 1e-5, the parameters by the 1-step rule."""
    ref = _jax_run("causal_pipeline_v0", 1)
    state, metrics, grads = _port_run("causal_pipeline_v0", 1, monkeypatch)
    for k, v in ref["metrics"][0].items():
        np.testing.assert_allclose(metrics[0][k], v, rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    m = metrics[0]
    np.testing.assert_allclose(m["loss"], m["score_mse"] + 1e-3 * m["kl"],
                               rtol=1e-6)
    _check_params(state, ref["states"][0], grads[0], 1,
                  preset("causal_pipeline_v0").optim.lr)


def test_remat_step_equals_plain(monkeypatch):
    """2 steps with ``model.remat`` (the backbone under
    ``torch.utils.checkpoint``) equal 2 plain steps bit for bit: the
    parameters, the BatchNorm running statistics and counts (updated once
    a step, not again by the recomputation) and Adam's state."""
    runs = [_port_run("causal_pipeline", 2, monkeypatch, remat=r)[0]
            for r in (False, True)]
    a, b = (r.model.state_dict() for r in runs)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(b["backbone.layer1.1.num_batches_tracked"]) == 2
    assert torch.equal(runs[0].opt_state.mu, runs[1].opt_state.mu)
    assert torch.equal(runs[0].opt_state.nu, runs[1].opt_state.nu)


def test_bf16_step(monkeypatch):
    """``train.dtype='bfloat16'`` runs the model in bf16 (parameters and
    BatchNorm statistics stay float32, the scores and KL leave in
    float32): from the same weights and draw, the step's loss within 2e-2
    of the float32 step's."""
    JaxNoise(monkeypatch)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg(dtype=dtype)
        task = build_task(cfg)
        assert task.model_cfg.dtype == dtype
        state = task.init_state(0, "cpu")
        state.model.load_state_dict(_init_state("causal_pipeline"))
        model_dropout_off(state.model)
        u8, labels = _stream()
        with torch.no_grad():
            out = copy.deepcopy(state.model).eval()(
                frames(u8[0].astype(np.float32) / 255.0))
        assert out["anomaly_scores"].dtype == torch.float32
        assert out["kl_losses"].dtype == torch.float32
        assert out["causal_factors"].dtype == getattr(torch, dtype)
        state, m = task.train_step(state, {
            "clips": torch.from_numpy(u8[0]),
            "labels": torch.from_numpy(labels[0])}, 1)
        assert all(p.dtype == torch.float32
                   for p in state.model.state_dict().values()
                   if p.is_floating_point())
        losses[dtype] = float(m["loss"])
    assert np.isfinite(losses["bfloat16"])
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"],
                               rtol=2e-2)


def test_fit_resume_eval_and_cli(tmp_path, capsys):
    """Two epochs on synthetic clips (eval every epoch: ``val_acc``, the
    best metric, and ``analysis``); two epochs resumed from the first equal
    the uninterrupted run bit for bit; ``train --preset causal_pipeline``,
    ``eval`` and ``auc --family a`` (a ``.pth`` over a frame-folder tree)
    run on the CPU."""
    from cvad_tpu_torch.cli import main

    cfg = _cfg(num_epochs=2, save_interval=1, log_every=1000)
    # the cosine schedule's length fixed, so that the interrupted run (1
    # epoch) decays the lr as the 2-epoch run does
    cfg = cfg.replace(optim=cfg.optim.replace(cosine_steps=2))
    loaders = make_loaders(cfg, n_synthetic=8)
    full = Trainer(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    hist = full.fit(*loaders)
    evals = hist["evaluation_metrics"]
    assert len(evals) == 2 and {"val_acc", "auc", "f1"} <= set(evals[0])
    assert full._best == max(e["val_acc"] for e in evals)
    metrics = full.evaluate(loaders[1])
    assert metrics["analysis"]["total_samples"] == len(loaders[1].dataset)
    assert metrics["direct_predictions"].shape == (len(loaders[1].dataset),
                                                   2)
    first = Trainer(cfg.replace(train=cfg.train.replace(num_epochs=1)),
                    out_dir=str(tmp_path / "res"), device="cpu")
    first.fit(*loaders)
    resumed = Trainer(cfg, out_dir=str(tmp_path / "res"), device="cpu")
    assert resumed.restore() == 1
    resumed.fit(*loaders)
    a, b = full.state.model.state_dict(), resumed.state.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(full.state.opt_state.nu, resumed.state.opt_state.nu)
    assert full.history.as_dict() == resumed.history.as_dict()

    sets = ["--set", f"data.frame_size={H},{W}", "--set",
            f"data.clip_len={T}", "--set", f"data.batch_size={B}"]
    out = str(tmp_path / "cli")
    argv = ["--preset", "causal_pipeline", "--out", out, "--n-synthetic",
            "4", "--device", "cpu"] + sets
    assert main(["train", "--epochs", "1"] + argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "epochs"] == 1
    assert main(["eval", "--step", "best"] + argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"val_acc", "accuracy", "checkpoint"} <= set(got)

    tree = str(tmp_path / "tree")
    assert main(["synth", "--out", tree, "--videos", "2", "--frames", "12",
                 "--hw", f"{H},{W}", "--write-gt"]) == 0
    capsys.readouterr()
    pth = str(tmp_path / "a.pth")
    torch.save({"model_state_dict": full.state.model.state_dict()}, pth)
    assert main(["auc", "--preset", "causal_pipeline", "--data-root", tree,
                 "--torch-checkpoint", pth, "--family", "a",
                 "--device", "cpu"] + sets) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["n_videos"] == 2 and got["n_frames"] == 24


def test_float64_copy_runs_float64(monkeypatch):
    """A copy cast with ``.double()`` (the reference `chip_smoke.py` holds
    the card's first-step gradient against) runs in float64 throughout:
    from the same weights and VAE draw, its train-mode outputs within 1e-5
    of float32's (the boxes within 1e-3 px), its loss gradient within 1e-3 of each leaf's largest
    entry (the masks equal, the boxes' margins held)."""
    from cvad_tpu_torch.ops.losses import family_a_loss
    from cvad_tpu_torch.train.tasks import stop_bn_absorbed_biases

    JaxNoise(monkeypatch)
    m32 = model(seed=1, mixed=True).train()
    m64 = copy.deepcopy(m32).double()
    x = frames(clips(5))
    labels = torch.tensor([0.0, 1.0])
    outs, grads = [], []
    for m, xx in ((m32, x), (m64, x.double())):
        out = m(xx)
        outs.append(out)
        grads.append(stop_bn_absorbed_biases(
            m, family_a_loss(out, labels)[0]))
    assert_margins(outs[0])
    for k, v in outs[1].items():
        if v.is_floating_point():
            assert v.dtype == torch.float64, k
            np.testing.assert_allclose(outs[0][k].detach().numpy(),
                                       v.detach().numpy(), rtol=0,
                                       atol=1e-3 if k == "detections"
                                       else 1e-5, err_msg=k)
        else:
            assert torch.equal(v, outs[0][k]), k
    for g32, g64 in zip(*grads):
        assert g64.dtype == torch.float64
        tol = 1e-3 * float(g64.abs().max())
        np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=0,
                                   atol=tol)


def test_chip_smoke_pins_family_a_decisions():
    """`chip_smoke.Pools` pins the backbone's `max_pool2d` (k3, stride 2,
    padding 1) as it pins family C's `max_pool3d`: a window whose two
    largest values float32 rounds to a tie takes float64's choice; with
    `Relus` and `Pools`, one max-pool call in a family-A step, and the
    CPU's float32 gradient (`loss_grads`, the mixed detector) lies within
    GRAD_F64_REL of float64's on every leaf."""
    import importlib.util
    from pathlib import Path

    import torch.nn.functional as F

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    x64 = torch.zeros(1, 1, 3, 3, dtype=torch.float64)
    x64[0, 0, 0, 0] = 1.0
    x64[0, 0, 1, 1] = 1.0 + 1e-12  # float32 rounds it to 1.0
    with cs.Pools() as rec:
        out = F.max_pool2d(x64, 3, stride=2, padding=1)
    assert rec.indices[0].reshape(-1).tolist() == [4, 4, 4, 4]
    x32 = x64.float().requires_grad_()
    with cs.Pools(rec.indices):
        got = F.max_pool2d(x32, 3, stride=2, padding=1)
    got.sum().backward()
    assert torch.equal(got.detach(), out.float())
    assert float(x32.grad[0, 0, 1, 1]) == 4.0 and float(x32.grad.sum()) == 4
    cfg = _cfg()
    u8, labels = _stream()
    batch = {"clips": u8[0], "labels": labels[0]}
    m = model(preset("causal_pipeline").model, seed=1, mixed=True)
    with cs.Relus() as relus, cs.Pools() as pools:
        g64 = cs.loss_grads(cfg, m, batch, torch.float64)
    with cs.Relus(relus.masks), cs.Pools(pools.indices):
        g32 = cs.loss_grads(cfg, m, batch, torch.float32)
    assert len(pools.indices) == 1 and len(relus.masks) > 10
    assert max(cs.rel_errs(g32, g64).values()) <= cs.GRAD_F64_REL


def test_unread_parameters_are_declared():
    """The train step's gradients are strict: a parameter that no loss
    reads raises unless its model declares it in `zero_grad_params`, and a
    declared one (family A's structure_params, the anchor detector's
    confidence head) gets exactly zero."""
    from cvad_tpu_torch.train.tasks import stop_bn_absorbed_biases

    for name, unread in (("causal_pipeline",
                          ["structure_learner.structure_params"]),
                         ("causal_pipeline_v0",
                          ["structure_learner.structure_params",
                           "detector.conf_head.weight",
                           "detector.conf_head.bias"])):
        m = model(preset(name).model, seed=1)
        assert list(m.zero_grad_params) == unread
        out = m.train()(frames(clips(3)))
        named = [n for n, p in m.named_parameters() if p.requires_grad]
        grads = dict(zip(named, stop_bn_absorbed_biases(
            m, out["anomaly_scores"].sum())))
        for n in unread:
            assert not grads[n].any(), n
        m.zero_grad_params = unread[1:]
        out = m.train()(frames(clips(3)))
        with pytest.raises(RuntimeError, match="not have been used"):
            stop_bn_absorbed_biases(m, out["anomaly_scores"].sum())
