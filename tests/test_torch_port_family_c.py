"""Family C in the port against `cvad_tpu` on the CPU: the pools and the
MLP of `models/layers.py`, the `Simple3DCNNDetector` forward (eval and
train mode, BatchNorm statistics included), the carry both ways and a
reference-format ``.pth`` through `cvad_tpu`'s importer, 1 and 20 train
steps of the mini3d preset, the eval metrics, the block correlations, and
`Trainer.fit` with a resume and the CLI.

Weights come from the port's own initialisation (the reference's scheme)
and are carried to `cvad_tpu` by `to_jax_family_c`.  The frameworks cannot
share dropout's draws: `cvad_tpu`'s ``flax.linen.Dropout`` is patched to
return its input and the port's ``nn.Dropout`` layers get ``p = 0``.
"""

import copy
import functools
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvad_tpu_torch.config import FamilyCConfig, preset
from cvad_tpu_torch.models import Simple3DCNNDetector
from cvad_tpu_torch.models.layers import (adaptive_avg_pool2d, max_pool3d,
                                          mlp, run_seq)
from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_c,
                                               to_jax_family_c)
from cvad_tpu_torch.train.engine import Trainer, make_loaders
from cvad_tpu_torch.train.tasks import bn_absorbed_biases, build_task

B, T, HW, STEPS = 4, 8, 32, 20
CLIP = (T, HW, HW, 1)
ABSORBED = ["features.0.bias", "features.4.bias", "features.8.bias"]
# Adam's first steps move a parameter by ~lr * sign(g): where a gradient
# entry is within rounding of 0, the two frameworks' float sums (in other
# orders) can give it opposite signs.  Entries whose gradient is above
# TINY_G are held to PARAM_ATOL (2% of lr = 1e-3); the others to one
# opposite step, 2 lr per step, and they must stay a small share.
PARAM_ATOL = 2e-5
TINY_G = 1e-7
# after 20 steps: 2.5% of the 20 lr a parameter can move, and 98% of the
# parameters within a fifth of that
PARAM_ATOL_20 = 5e-4


def _jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    return jax


def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return model


def _cfg(frames=(HW, HW), **train):
    cfg = preset("mini3d")
    return cfg.replace(data=cfg.data.replace(frame_size=frames, clip_len=T,
                                             batch_size=B),
                       train=cfg.train.replace(**train))


def _stream():
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (STEPS, B) + CLIP, dtype=np.uint8)
    labels = (rng.uniform(size=(STEPS, B)) < 0.5).astype(np.float32)
    labels[:, :2] = (0.0, 1.0)  # both classes in every batch
    return clips, labels


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(1, 2), (3, 4), (2, 3), (8, 12), (13, 7),
                                (4, 6), (16, 24)])
def test_adaptive_avg_pool2d(hw):
    """Against torch's own and `cvad_tpu`'s at (4, 6), also where the input
    is smaller than the output (repeated windows): within 1e-6."""
    jax = _jax()
    from cvad_tpu.models.layers import adaptive_avg_pool2d as jax_pool

    x = np.random.default_rng(1).normal(size=(3, 5) + hw).astype(np.float32)
    got = adaptive_avg_pool2d(torch.from_numpy(x), (4, 6))
    want = F.adaptive_avg_pool2d(torch.from_numpy(x), (4, 6))
    assert got.shape == (3, 5, 4, 6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    jx = np.asarray(jax_pool(jax.numpy.asarray(x.transpose(0, 2, 3, 1)),
                             (4, 6)))
    np.testing.assert_allclose(got.numpy(), jx.transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


def test_max_pool3d_and_mlp():
    """`max_pool3d` equals `cvad_tpu`'s on (B, T, H, W, C) moved to torch's
    layout; `mlp`'s Linears sit at the reference's indices and the stack
    with carried weights equals `cvad_tpu`'s ``MLP`` within 1e-6."""
    jax = _jax()
    import jax.numpy as jnp
    from cvad_tpu.models.layers import MLP
    from cvad_tpu.models.layers import max_pool3d as jax_max_pool3d

    x = np.random.default_rng(2).normal(size=(2, 8, 12, 10, 3)).astype(
        np.float32)
    for k in ((1, 2, 2), (2, 2, 2)):
        got = max_pool3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), k)
        want = np.asarray(jax_max_pool3d(jnp.asarray(x), k))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(),
                                      want)
    seq = mlp(24, (512, 256, 128, 64, 2), "softmax", dropout_after=(0, 1),
              dropout_rates=(0.3, 0.2))
    linears = [i for i, m in enumerate(seq) if isinstance(m, torch.nn.Linear)]
    assert linears == [0, 3, 6, 8, 10]
    assert [m.p for m in seq if isinstance(m, torch.nn.Dropout)] == [0.3, 0.2]
    assert [i for i, m in enumerate(mlp(18, (64, 32, 1), "sigmoid",
                                        dropout=0.2, dropout_after=(0,)))
            if isinstance(m, torch.nn.Linear)] == [0, 3, 5]
    jm = MLP((512, 256, 128, 64, 2), final_activation="softmax",
             dropout_after=(0, 1), dropout_rates=(0.3, 0.2))
    params = {f"dense_{j}": {"kernel": seq[i].weight.detach().numpy().T,
                             "bias": seq[i].bias.detach().numpy()}
              for j, i in enumerate(linears)}
    inp = np.random.default_rng(3).normal(size=(5, 24)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(inp)))
    with torch.no_grad():
        got = run_seq(seq, torch.from_numpy(inp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- model -------------------------------------------------------------------

def _jax_model(cfg=None):
    _jax()
    from cvad_tpu.config import FamilyCConfig as JaxFamilyCConfig
    from cvad_tpu.models import Simple3DCNNDetector as JaxDetector

    return JaxDetector(JaxFamilyCConfig(**(cfg or FamilyCConfig()).to_dict()))


def test_forward_matches_jax():
    """From the same weights: eval scores within 1e-6; in train mode the
    scores within 1e-5 and the BatchNorm running statistics, updated from
    the batch, within 1e-6 (dropout off on both sides)."""
    jax = _jax()
    import flax.linen as fnn
    import jax.numpy as jnp

    model = _no_dropout(Simple3DCNNDetector(seed=3))
    v = to_jax_family_c(model.state_dict())
    x = np.random.default_rng(4).uniform(0, 1, (B,) + CLIP).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    jm = _jax_model()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(xt).numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        with jax.default_matmul_precision("highest"):
            want, mutated = jm.apply(v, jnp.asarray(x), train=True,
                                     deterministic=False,
                                     mutable=["batch_stats"])
    # `v` may alias the model's buffers, which its train forward below
    # updates in place: JAX must have read them first
    jax.block_until_ready((want, mutated))
    with torch.no_grad():
        got = model.train()(xt).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    ours = to_jax_family_c(model.state_dict())["batch_stats"]
    for name, leaf in ours.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                leaf[k], np.asarray(mutated["batch_stats"][name][k]),
                rtol=1e-5, atol=1e-6, err_msg=f"{name}.{k}")


def test_carry_and_reference_pth(tmp_path):
    """`to_jax_family_c` gives `cvad_tpu`'s tree (every key and shape of
    its ``init``), a ``.pth`` written by ``torch.save`` imports through
    `cvad_tpu`'s ``import_torch_family_c`` to the same values, and
    `from_jax_family_c` returns the state dict exactly."""
    jax = _jax()
    import jax.numpy as jnp
    from cvad_tpu.runtime.checkpoint import import_torch_family_c

    model = Simple3DCNNDetector(seed=5)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5)
    state = model.state_dict()
    ours = to_jax_family_c(state)
    shapes = jax.eval_shape(
        functools.partial(_jax_model().init, train=True),
        jax.random.key(0), jnp.zeros((1,) + CLIP))
    flat = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    ref = {k: s.shape for k, s in
           jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: np.shape(v) for k, v in flat.items()} == ref
    path = tmp_path / "c.pth"
    torch.save({"model_state_dict": state}, path)
    imported = import_torch_family_c(str(path))
    for k, v in jax.tree_util.tree_flatten_with_path(imported)[0]:
        np.testing.assert_array_equal(v, flat[k], err_msg=str(k))
    back = from_jax_family_c(ours)
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    fresh = Simple3DCNNDetector()
    fresh.load_state_dict(back, strict=True)


# -- train steps -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_task():
    _jax()
    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.train.tasks import build_task as jax_build_task

    jcfg = jax_preset("mini3d")
    return jax_build_task(jcfg.replace(data=jcfg.data.replace(
        frame_size=(HW, HW), clip_len=T, batch_size=B)))


@pytest.fixture(scope="module")
def jax_run():
    """`cvad_tpu`'s family-C step over the stream from the port's seed-0
    weights, dropout patched out: the initial weights, the state after
    steps 1 and STEPS, and every step's loss."""
    jax = _jax()
    import flax.linen as fnn
    import jax.numpy as jnp
    from cvad_tpu.train.state import make_state

    task = _jax_task()
    init = Simple3DCNNDetector(seed=0).state_dict()
    v = to_jax_family_c(init)
    state = make_state(v["params"], task.tx, batch_stats=v["batch_stats"])
    clips, labels = _stream()
    out = {"init": init, "loss": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        step = jax.jit(task.train_step)
        with jax.default_matmul_precision("highest"):
            for i in range(STEPS):
                state, m = step(state, {"clips": jnp.asarray(clips[i]),
                                        "labels": jnp.asarray(labels[i])},
                                jax.random.key(1))
                out["loss"].append(float(m["loss"]))
                if i + 1 in (1, STEPS):
                    out[i + 1] = from_jax_family_c(jax.device_get(
                        {"params": state.params,
                         "batch_stats": state.batch_stats}))
    return out


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_steps_match_jax(jax_run, steps):
    """From the same weights, dropout off: every step's loss within rtol
    1e-5; after 1 step the parameters within PARAM_ATOL where the step's
    gradient is above TINY_G (otherwise within 2 lr, under 0.1% of them);
    after 20 steps within PARAM_ATOL_20, 98% of them within a fifth of it
    (XLA's naive float32 sums in the
    BatchNorm backward differ from torch's by ~0.2% in the first block's
    gradient, see tests/test_torch_port_train_b.py; Adam carries such
    differences from step to step);
    the running statistics within 1e-5 relative and 2e-6 absolute (XLA's
    float32 sums on the CPU are naive: ~1e-6 of a batch mean of 0.1 over
    the 2,048 values a channel of the last block holds), and after 20
    steps, where they follow the parameters, within 1% of each leaf's
    largest entry; the BN-absorbed
    conv
    biases take exactly zero gradient, so they stay at their initial 0 on
    both sides."""
    cfg = _cfg()
    task = build_task(cfg)
    state = task.init_state(0, "cpu")
    state.model.load_state_dict(jax_run["init"], strict=True)
    _no_dropout(state.model)
    assert bn_absorbed_biases(state.model) == ABSORBED
    clips, labels = _stream()
    for i in range(steps):
        mu_before = state.opt_state.mu.clone()
        state, m = task.train_step(state, {
            "clips": torch.from_numpy(clips[i]),
            "labels": torch.from_numpy(labels[i])}, 1)
        np.testing.assert_allclose(float(m["loss"]), jax_run["loss"][i],
                                   rtol=1e-5, err_msg=f"step {i}")
    # the last step's gradient (after the clip), from Adam's first moment
    grad = (state.opt_state.mu - 0.9 * mu_before) / 0.1
    want = jax_run[steps]
    got = state.model.state_dict()
    sizes = [p.numel() for p in state.params()]
    names = [n for n, p in state.model.named_parameters()]
    tiny = total = 0
    lr = cfg.optim.lr
    for name, g in zip(names, grad.split(sizes)):
        d = (got[name] - want[name]).abs().reshape(-1)
        if steps > 1:
            assert float(d.max()) <= PARAM_ATOL_20, name
            tiny += int((d > PARAM_ATOL_20 / 5).sum())
            total += d.numel()
            continue
        small = g.abs() <= TINY_G
        assert float(torch.where(small, 0.0, d).max()) <= PARAM_ATOL, name
        assert float(d.max()) <= 2 * lr, name
        tiny += int((d[small] > PARAM_ATOL).sum())
        total += d.numel()
    assert tiny <= (0.02 if steps > 1 else 1e-3) * total
    for name in ABSORBED:
        assert not got[name].any() and not want[name].any(), name
    for k in want:
        if "running" in k:
            w = want[k].numpy()
            rtol, atol = ((1e-5, 2e-6) if steps == 1
                          else (0.0, 1e-2 * float(np.abs(w).max())))
            np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                       atol=atol, err_msg=k)
    moved = max(float((want[n] - jax_run["init"][n]).abs().max())
                for n in names)
    assert moved > 0.5 * lr


# -- eval --------------------------------------------------------------------

def test_eval_metrics_and_block_correlations():
    """The eval step's metrics equal `cvad_tpu`'s binary metrics (scikit-
    learn) and mean BCE; `best_metric` is 'auc'.  The block correlations
    from the same weights equal `cvad_tpu`'s within 1e-4."""
    _jax()
    pytest.importorskip("sklearn")
    from cvad_tpu.evaluation.block_correlation import (
        block_channel_correlations as jax_corr)
    from cvad_tpu.evaluation.metrics import binary_metrics as jax_binary
    from cvad_tpu_torch.evaluation.block_correlation import \
        block_channel_correlations

    cfg = _cfg()
    assert cfg.train.best_metric == "auc"
    task = build_task(cfg)
    state = task.init_state(2, "cpu")
    clips, labels = _stream()
    out = task.eval_step(state, {"clips": torch.from_numpy(clips[0]),
                                 "labels": torch.from_numpy(labels[0])})
    from cvad_tpu_torch.evaluation.metrics import family_c_eval_metrics

    pred = out["predictions"].numpy()
    got = family_c_eval_metrics(pred, labels[0], out["loss"].numpy())
    want = jax_binary(pred, labels[0])
    want["loss"] = float(np.mean(out["loss"].numpy()))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    x = clips[1].astype(np.float32) / 255.0
    ours = block_channel_correlations(state.model.state_dict(), x,
                                      device="cpu")
    theirs = jax_corr(to_jax_family_c(state.model.state_dict()), x)
    assert [m.shape for m in ours] == [(8, 8), (16, 16), (32, 32)]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


# -- fit, resume, CLI --------------------------------------------------------

def test_fit_resume_and_cli(tmp_path, capsys):
    """Two epochs on synthetic clips with eval (auc) and a checkpoint an
    epoch; two epochs resumed from the first equal the uninterrupted run
    bit for bit; ``train --preset mini3d`` and ``eval`` on the CPU print
    the eval keys; the `best` checkpoint scores through
    ``make_score_fn('c')`` as the eval step does."""
    from cvad_tpu_torch.cli import main
    from cvad_tpu_torch.evaluation.scoring import make_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    cfg = _cfg((16, 16), num_epochs=2, save_interval=1, log_every=1000)
    loaders = make_loaders(cfg, n_synthetic=16)
    full = Trainer(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    hist = full.fit(*loaders)
    assert len(hist["epochs"]) == 2 and np.isfinite(hist["train_losses"]).all()
    assert set(hist["evaluation_metrics"][0]) >= {"auc", "loss", "accuracy"}
    first = Trainer(cfg.replace(train=cfg.train.replace(num_epochs=1)),
                    out_dir=str(tmp_path / "res"), device="cpu")
    first.fit(*loaders)
    resumed = Trainer(cfg, out_dir=str(tmp_path / "res"), device="cpu")
    assert resumed.restore() == 1
    resumed.fit(*loaders)
    for (k, a), b in zip(full.state.model.state_dict().items(),
                         resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(full.state.opt_state.mu, resumed.state.opt_state.mu)
    assert full.history.as_dict() == resumed.history.as_dict()

    clips = np.stack([loaders[1].dataset[i][0] for i in range(4)])
    best = load_torch_state_dict(str(full.ckpt.path("best")))
    scores = make_score_fn("c", best, device="cpu")(clips)
    ref = Trainer(cfg, out_dir=str(tmp_path / "ref"), device="cpu")
    ref.init_state()
    ref.state.load_state_dict(full.ckpt.restore("best"))
    want = ref.task.eval_step(ref.state, ref.put_batch(
        {"clips": clips, "labels": np.zeros(4, np.float32)}))
    np.testing.assert_allclose(scores, want["predictions"].numpy(), rtol=0,
                               atol=1e-6)

    out = str(tmp_path / "cli")
    argv = ["--preset", "mini3d", "--out", out, "--n-synthetic", "8",
            "--set", "data.frame_size=16,16", "--device", "cpu"]
    assert main(["train", "--epochs", "1"] + argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "epochs"] == 1
    assert main(["eval", "--step", "best"] + argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"accuracy", "loss", "checkpoint"} <= set(got)


def test_cli_auc_matches_jax(tmp_path, capsys):
    """``auc --family c --preset mini3d`` from a reference-format ``.pth``
    over a frame-folder tree (the port's ``synth``) prints `cvad_tpu`'s
    frame AUCs within 1e-6."""
    jax = _jax()
    pytest.importorskip("sklearn")
    from cvad_tpu import cli as jax_cli
    from cvad_tpu_torch.cli import main

    tree = str(tmp_path / "tree")
    assert main(["synth", "--out", tree, "--videos", "2", "--frames", "24",
                 "--write-gt"]) == 0
    path = str(tmp_path / "c.pth")
    torch.save({"model_state_dict": Simple3DCNNDetector(seed=7).state_dict()},
               path)
    capsys.readouterr()
    args = ["auc", "--preset", "mini3d", "--data-root", tree,
            "--torch-checkpoint", path, "--family", "c"]
    assert main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with jax.default_matmul_precision("highest"):
        assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) and got["n_frames"] == 48
    for k, v in want.items():
        assert (v is None and got[k] is None) or abs(got[k] - v) <= 1e-6, k


def test_float64_copy_runs_float64():
    """A copy cast with ``.double()`` runs in float64 (BatchNorm
    statistics included): train-mode scores within 1e-6 of float32's."""
    m32 = _no_dropout(Simple3DCNNDetector(seed=8)).train()
    m64 = copy.deepcopy(m32).double()
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (B, 1, T, HW, HW)).astype(np.float32))
    s32, s64 = m32(x), m64(x.double())
    assert s64.dtype == torch.float64
    assert m64.features[1].running_mean.dtype == torch.float64
    np.testing.assert_allclose(s32.detach().numpy(), s64.detach().numpy(),
                               rtol=0, atol=1e-6)


def _chip_smoke():
    """chip_smoke.py at the repo's root (its first-step gradient check,
    `grad_parity`, pins the ReLU masks and max-pool argmaxes)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_pins_max_pools():
    """`chip_smoke.Pools` replays float64's argmax: a window whose two
    largest values float32 rounds to a tie takes float64's choice (its
    gradient goes there), an unpinned pool's output is unchanged, a
    replay with fewer calls fails; with `Relus` and `Pools` the CPU's
    float32 gradient of a family-C step (`loss_grads`) lies within
    GRAD_F64_REL of float64's on every leaf."""
    cs = _chip_smoke()
    x64 = torch.zeros(1, 1, 2, 2, 2, dtype=torch.float64)
    x64[0, 0, 0, 0, 0] = 1.0
    x64[0, 0, 1, 1, 1] = 1.0 + 1e-12  # float32 rounds it to 1.0
    with cs.Pools() as rec:
        out = max_pool3d(x64, (2, 2, 2))
    assert int(rec.indices[0].reshape(-1)) == 7
    x32 = x64.float().requires_grad_()
    with cs.Pools(rec.indices):
        got = max_pool3d(x32, (2, 2, 2))
    got.sum().backward()
    assert float(got.detach()) == float(out.float())
    assert float(x32.grad.reshape(-1)[7]) == 1.0
    with pytest.raises(RuntimeError, match="recorded"):
        with cs.Pools(rec.indices + rec.indices):
            max_pool3d(x32, (2, 2, 2))
    cfg = _cfg((16, 16))
    batch = {"clips": _stream()[0][0][:, :, :16, :16],
             "labels": _stream()[1][0]}
    model = _no_dropout(build_task(cfg).init_state(0, "cpu").model)
    with cs.Relus() as relus, cs.Pools() as pools:
        g64 = cs.loss_grads(cfg, model, batch, torch.float64)
    with cs.Relus(relus.masks), cs.Pools(pools.indices):
        g32 = cs.loss_grads(cfg, model, batch, torch.float32)
    assert len(relus.masks) == 5 and len(pools.indices) == 3
    assert max(cs.rel_errs(g32, g64).values()) <= cs.GRAD_F64_REL


def test_chip_smoke_step_rule():
    """`chip_smoke.pinned_step` from the CPU run's train state before its
    second step, decisions replayed from the float64 forward, twice on the
    CPU: `step_readings` reads every difference 0 and `step_holds`; it
    fails where a steady entry (its gradient above STEP_TINY_REL of its
    leaf's largest) is off by 2 STEP_PARAM_ATOL, where any entry is off by
    more than 2 lr, and where more than STEP_FAR_SHARE of the entries lie
    beyond STEP_PARAM_ATOL."""
    cs = _chip_smoke()
    cfg = _cfg()
    clips, labels = _stream()
    batches = [{"clips": clips[i], "labels": labels[i]} for i in range(2)]
    run = cs.steps_on(cfg, batches, None, "cpu")
    before = run[3][1]
    model = _no_dropout(build_task(cfg).init_state(0, "cpu").model)
    model.load_state_dict(before["model_state_dict"], strict=True)
    with cs.Relus() as relus, cs.Pools() as pools:
        cs.loss_grads(cfg, model, batches[1], torch.float64, 1)
    pins = (relus.masks, pools.indices)
    a, b = (cs.pinned_step(cfg, before, batches[1], 1, "cpu", pins)
            for _ in range(2))
    lr = cfg.optim.lr
    r = cs.step_readings(a, b)
    assert r["params_max_abs_err"] == 0.0 and r["grad_max_rel_err"] == 0.0
    assert cs.step_holds(r, lr) and 0.5 < r["params_steady_share"] < 1.0
    assert abs(a[0]["loss"] - run[0][1]["loss"]) <= 1e-6 * run[0][1]["loss"]
    name = "features.4.weight"
    rel = (a[2][name].abs() / a[2][name].abs().max()).reshape(-1)
    steady, tiny = (int(torch.nonzero(cond)[0])
                    for cond in (rel > cs.STEP_TINY_REL,
                                 rel <= cs.STEP_TINY_REL))
    for i, shift, ok in ((tiny, 1.5 * lr, True),
                         (steady, 2 * cs.STEP_PARAM_ATOL, False),
                         (tiny, 2 * lr + 1e-4, False)):
        state = {k: v.clone() for k, v in b[1].items()}
        state[name].view(-1)[i] += shift
        assert cs.step_holds(cs.step_readings(a, (b[0], state) + b[2:]),
                             lr) == ok
    # entries whose gradient is not steady, off by 2 STEP_PARAM_ATOL (within
    # 2 lr): just over STEP_FAR_SHARE of all entries
    state = {k: v.clone() for k, v in b[1].items()}
    left = int(cs.STEP_FAR_SHARE * sum(g.numel() for g in a[2].values())) + 1
    for n, g in a[2].items():
        rel = (g.abs() / max(float(g.abs().max()), 1e-30)).reshape(-1)
        idx = torch.nonzero(rel <= cs.STEP_TINY_REL)[:left, 0]
        state[n].view(-1)[idx] += 2 * cs.STEP_PARAM_ATOL
        left -= len(idx)
    assert left == 0
    assert not cs.step_holds(cs.step_readings(a, (b[0], state) + b[2:]), lr)


def test_unread_knobs_are_refused():
    """`cvad_tpu`'s ``model.conv_mode`` (family C; every value is the same
    XLA conv there) and ``model.frame_hw`` (family A; read nowhere) are
    not carried: ``--set`` refuses them as unknown fields.  The CLI and the
    engine name a family by the one map `FAMILY_CONFIGS`."""
    from cvad_tpu_torch import cli
    from cvad_tpu_torch.config import FAMILY_CONFIGS, family_of

    for name, knob in (("mini3d", "model.conv_mode=tfold"),
                       ("causal_pipeline", "model.frame_hw=240,360")):
        with pytest.raises(AttributeError):
            cli._apply_overrides(preset(name), [knob])
    for family, cls in FAMILY_CONFIGS.items():
        assert family_of(cls()) == family
    assert cli._family_model(preset("mini3d"), "c") == preset("mini3d").model
    assert cli._family_model(preset("mini3d"), "a") is None
    assert cli._family_model(preset("mini3d"), "e") is None
    with pytest.raises(NotImplementedError):
        family_of(preset("mini3d").data)
