"""Family D on long windows in the port against `cvad_tpu` on the CPU: the
conv1 routing table (where `cvad_tpu` runs its s2d group kernel K5, and
where it raises), the T=16 forward on the K5 route, 1 and 3 train steps on
it, and the CLI training and resuming at ``clip_len=16``.

The frameworks cannot share random draws: the step tests set dropout to 0
and pass the labels in as ``pseudo_targets``.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # cvad_tpu's models
import jax.numpy as jnp  # noqa: E402

from cvad_tpu.config import FamilyDConfig as JaxFamilyDConfig  # noqa: E402
from cvad_tpu.config import preset as jax_preset  # noqa: E402
from cvad_tpu.models import CausalAnomalyDetector as JaxDetector  # noqa: E402
from cvad_tpu.train.tasks import build_task as jax_build_task  # noqa: E402
from cvad_tpu_torch.config import (CONV1_MODES, CONV_GROUP_IMPLS,  # noqa: E402
                                   CONV_STACKS, FamilyDConfig, preset)
from cvad_tpu_torch.models import CausalAnomalyDetector  # noqa: E402
from cvad_tpu_torch.models import layers  # noqa: E402
from cvad_tpu_torch.models.family_d import conv1_route  # noqa: E402
from cvad_tpu_torch.runtime.checkpoint import (  # noqa: E402
    CheckpointManager, from_jax_family_d, from_jax_opt_state,
    to_jax_family_d)
from cvad_tpu_torch.train.tasks import build_task  # noqa: E402

S2D = dict(conv1_mode="tfold", conv_group_impl="s2d")


@pytest.fixture
def k5_calls(monkeypatch):
    """Counts the port's calls of `s2d_group_conv` (K5) from conv1."""
    calls = []
    real = layers.s2d_group_conv

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(layers, "s2d_group_conv", counted)
    return calls


# -- routing -------------------------------------------------------------------


def _jax_routes(monkeypatch, t, gi, combos):
    """`cvad_tpu`'s choice for each (conv1_mode, conv_stack): 's2d' where
    tracing family D's encoder calls `s2d_group_conv`, 'raise' where it
    raises ValueError, 'tfold' otherwise."""
    from cvad_tpu.models.family_d import CompactFeatureExtractor
    from cvad_tpu.ops import pallas_s2d as jps

    calls = []
    real = jps.s2d_group_conv

    def recorded(*args, **kw):
        calls.append(1)
        return real(*args, **{**kw, "use_pallas": False})

    monkeypatch.setattr(jps, "s2d_group_conv", recorded)
    x = jnp.zeros((1, t, 16, 16, 3))
    out = {}
    for mode, stack in combos:
        m = CompactFeatureExtractor(JaxFamilyDConfig(
            conv1_mode=mode, conv_stack=stack, conv_group_impl=gi))
        calls.clear()
        try:
            jax.eval_shape(lambda: m.init(jax.random.key(0), x))
            out[mode, stack] = "s2d" if calls else "tfold"
        except ValueError:
            out[mode, stack] = "raise"
    return out


def _port_route(mode, stack, gi, t, on_cpu, **kw):
    try:
        return conv1_route(FamilyDConfig(conv1_mode=mode, conv_stack=stack,
                                         conv_group_impl=gi),
                           t, 16, 16, on_cpu, **kw)
    except ValueError:
        return "raise"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("gi", CONV_GROUP_IMPLS)
@pytest.mark.parametrize("t", [8, 16])
def test_routing_table_matches_jax(monkeypatch, device, gi, t):
    """conv1_mode x conv_stack at one conv_group_impl and T: the port routes
    conv1 to K5 exactly where `cvad_tpu` calls `s2d_group_conv`, and raises
    where it raises.  'auto' resolves by backend in `cvad_tpu` and by the
    input's device in the port: the 'cuda' case traces `cvad_tpu` as on an
    accelerator for the combinations that hold an 'auto', and holds the
    others to the CPU answer (explicit values do not depend on it)."""
    combos = [(m, s) for m in CONV1_MODES for s in CONV_STACKS]
    on_cpu = device == "cpu"
    if not on_cpu:
        monkeypatch.setenv("CVAD_PLATFORM", "gpu")
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        explicit = [c for c in combos if "auto" not in c]
        for mode, stack in explicit:
            assert (_port_route(mode, stack, gi, t, False)
                    == _port_route(mode, stack, gi, t, True)), (mode, stack)
        combos = [c for c in combos if "auto" in c]
    want = _jax_routes(monkeypatch, t, gi, combos)
    got = {(m, s): _port_route(m, s, gi, t, on_cpu) for m, s in combos}
    assert got == want
    if t == 8:  # the whole-T fold: K1 whatever the knobs
        assert "s2d" not in got.values()
    if gi == "s2d" and t == 16:  # the main path's and the tests' settings
        assert got["auto", "auto"] == ("tfold" if on_cpu else "s2d")
        assert _port_route("tfold", "ndhwc", gi, t, on_cpu) == "s2d"


def test_unknown_lowering_is_refused():
    with pytest.raises(ValueError, match="conv_group_impl"):
        FamilyDConfig(conv_group_impl="window")


# -- the model at T=16 ---------------------------------------------------------


def _port_apply(model, clips):
    x = torch.from_numpy(clips).permute(0, 4, 1, 2, 3).contiguous()
    with torch.inference_mode():
        s, adj, feat = model.eval()(x)
    return s.numpy(), adj.numpy(), feat.numpy()


def test_forward_on_k5_route_matches_jax_and_k1(k5_calls):
    """Family D at T=16, 64x64 on the K5 route against `cvad_tpu`'s model
    with the same lowering, fed by `to_jax_family_d` of the same weights:
    scores within 1e-6 and features within 1e-5 (as
    tests/test_s2d_fold.py:202-221), and against the port's own K1 route."""
    torch.manual_seed(3)
    model = CausalAnomalyDetector(FamilyDConfig(**S2D))
    clips = np.random.default_rng(4).uniform(
        0, 1, (2, 16, 64, 64, 3)).astype(np.float32)
    s, adj, feat = _port_apply(model, clips)
    assert len(k5_calls) == 1 and k5_calls[0] == (2, 33, 33, 2 * 128)
    with jax.default_matmul_precision("highest"):
        js, jadj, jf = JaxDetector(JaxFamilyDConfig(**S2D)).apply(
            to_jax_family_d(model.state_dict()), jnp.asarray(clips))
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(feat, np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(adj, np.asarray(jadj), atol=1e-5)
    k1 = CausalAnomalyDetector(FamilyDConfig())
    k1.load_state_dict(model.state_dict())
    s1, adj1, f1 = _port_apply(k1, clips)
    assert len(k5_calls) == 1  # the default lowering stays on K1
    np.testing.assert_allclose(s, s1, atol=1e-6)
    np.testing.assert_allclose(feat, f1, atol=1e-5)


# -- train steps at T=16 -------------------------------------------------------

TB, TT, HW, STEPS = 4, 16, 16, 3
# as tests/test_torch_port_train_step.py: Adam's first steps are close to
# lr * sign(g), so near-zero gradient entries can move by up to ~lr
PARAM_ATOL = 2e-5


def _configs():
    jcfg = jax_preset("family_d")
    jcfg = jcfg.replace(model=jcfg.model.replace(dropout=0.0, **S2D),
                        data=jcfg.data.replace(clip_len=TT,
                                               frame_size=(HW, HW)))
    cfg = preset("family_d")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0, **S2D),
                      data=cfg.data.replace(clip_len=TT, frame_size=(HW, HW)))
    return jcfg, cfg


def _stream():
    rng = np.random.default_rng(9)
    clips = rng.integers(0, 256, (STEPS, TB, TT, HW, HW, 3), dtype=np.uint8)
    targets = (rng.uniform(size=(STEPS, TB)) < 0.25).astype(np.float32)
    return clips, targets


@pytest.fixture(scope="module")
def jax_run():
    jcfg, _ = _configs()
    task = jax_build_task(jcfg)
    clips, targets = _stream()
    state = task.init_state(jax.random.key(0),
                            {"clips": jnp.asarray(clips[0])})
    out = {"init": jax.device_get(state), "metrics": []}
    step = jax.jit(task.train_step)
    with jax.default_matmul_precision("highest"):
        for i in range(STEPS):
            state, m = step(state, {"clips": jnp.asarray(clips[i]),
                                    "pseudo_targets": jnp.asarray(targets[i])},
                            jax.random.key(1))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out[i + 1] = jax.device_get(state)
    return out


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_steps_on_k5_route_match_jax(jax_run, k5_calls, steps):
    """From the same parameters and optimizer state: every step's loss and
    components, then the parameters, both moments and Adam's count."""
    _, cfg = _configs()
    task = build_task(cfg)
    state = task.init_state(0, "cpu")
    state.model.load_state_dict(
        from_jax_family_d({"params": jax_run["init"].params}), strict=True)
    state.opt_state = from_jax_opt_state(jax_run["init"].opt_state,
                                         state.model)
    clips, targets = _stream()
    for i in range(steps):
        state, m = task.train_step(
            state, {"clips": torch.from_numpy(clips[i]),
                    "pseudo_targets": torch.from_numpy(targets[i])}, 1)
        ref = jax_run["metrics"][i]
        for k in ref:
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert len(k5_calls) == steps
    js = jax_run[steps]
    jp = from_jax_family_d({"params": js.params})
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jp[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    jopt = from_jax_opt_state(js.opt_state, state.model)
    np.testing.assert_allclose(state.opt_state.mu.numpy(), jopt.mu.numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(state.opt_state.nu.numpy(), jopt.nu.numpy(),
                               rtol=1e-3, atol=1e-11)
    assert int(state.opt_state.count) == int(jopt.count) == steps


# -- the float64 reference gradient --------------------------------------------


def _chip_smoke():
    """chip_smoke.py at the repo's root, whose `long_train_parity` holds the
    card's gradient against the CPU's float64 one (`step_grads`)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_float64_step_gradient_stays_float64(k5_calls):
    """`chip_smoke.step_grads` with dtype=float64 at T=16, B=2 on the K5
    route (the plain versions of K5 and K2 on the CPU): no operation of the
    forward or the backward turns a float64 operand into a lower-precision
    result (a dispatch-level audit), every leaf is float64 and within 1e-4
    of its largest entry of the float32 gradient; the CUDA wrappers of K2
    and K5 still refuse float64."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from cvad_tpu_torch.ops import pallas_kernels, pallas_s2d

    class Downcasts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if any(t.dtype == torch.float64 for t in ins) and any(
                    isinstance(o, torch.Tensor) and o.is_floating_point()
                    and o.dtype != torch.float64 for o in tree_leaves(out)):
                self.seen.add(str(func))
            return out

    cs = _chip_smoke()
    cfg = preset("family_d")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0, **S2D),
                      data=cfg.data.replace(clip_len=16))
    model = build_task(cfg).init_state(0, "cpu").model
    rng = np.random.default_rng(5)
    clips = rng.integers(0, 256, (2, 16, 32, 32, 3), dtype=np.uint8)
    targets = np.array([0.0, 0.0], np.float32)  # one pair for K2
    g32 = cs.step_grads(cfg, model, clips, targets, 0)
    with Downcasts() as audit:
        g64 = cs.step_grads(cfg, model, clips, targets, 0,
                            dtype=torch.float64)
    assert not audit.seen
    assert len(k5_calls) == 2
    assert next(model.parameters()).dtype == torch.float32
    for name, g in g64.items():
        assert g.dtype == torch.float64, name
        ref = g.abs().max().item()
        assert 0 < ref and (g32[name].double() - g).abs().max().item() \
            <= 1e-4 * ref, name
    flat = torch.rand(4, 8, dtype=torch.float64)
    mask = torch.ones(4, dtype=torch.float64)
    with pytest.raises(TypeError):
        pallas_kernels._launch_forward(flat, mask)
    with pytest.raises(TypeError):
        pallas_kernels._launch_backward(flat, mask, torch.ones(()),
                                        torch.ones(()))
    xg = torch.zeros(2, 9, 9, 128, dtype=torch.float64)
    wdp = torch.zeros(4, 128, 64, dtype=torch.float64)
    with pytest.raises(TypeError):
        pallas_s2d._launch_group_forward(xg, wdp, 4, 3, 16)
    with pytest.raises(TypeError):
        pallas_s2d._launch_group_wgrad(
            xg, torch.zeros(2, 8, 8, 64, dtype=torch.float64), 4, 3, 16, 128)


# -- the CLI -------------------------------------------------------------------


def test_cli_trains_and_resumes_long_windows(tmp_path, capsys, k5_calls):
    """`cli train` at clip_len=16 with conv_group_impl='s2d' on the CPU: conv1
    runs the K5 route, and 1 epoch + --resume + epoch 2 equals 2 epochs
    straight (parameters, optimizer state, history)."""
    from cvad_tpu_torch.cli import main

    args = ["train", "--n-synthetic", "8", "--device", "cpu",
            "--set", "data.batch_size=4", "--set", "data.clip_len=16",
            "--set", "data.frame_size=16,16",
            "--set", "model.conv_group_impl=s2d",
            "--set", "model.conv1_mode=tfold",
            "--set", "train.save_interval=1", "--set", "train.eval_every=1"]
    full, part = tmp_path / "full", tmp_path / "resumed"
    assert main(args + ["--epochs", "2", "--out", str(full)]) == 0
    assert main(args + ["--epochs", "1", "--out", str(part)]) == 0
    assert main(args + ["--epochs", "2", "--resume", "--out", str(part)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]  # the CLI's own lines, not the log's
    assert lines[-2] == {"resumed_from": 1}
    res = lines[-1]
    assert res["epochs"] == 2 and np.isfinite(res["final_loss"])
    cfg = json.loads((part / "config.json").read_text())
    assert cfg["data"]["clip_len"] == 16
    assert cfg["model"]["conv_group_impl"] == "s2d"
    # 4 epochs trained in all, each 2 train steps and 1 eval batch (4 clips)
    assert len(k5_calls) == 4 * (2 + 1)
    a = CheckpointManager(full / "checkpoints").restore(2)
    b = CheckpointManager(part / "checkpoints").restore(2)
    for part_name in ("model_state_dict", "optimizer"):
        for k, v in a[part_name].items():
            assert torch.equal(v, b[part_name][k]), (part_name, k)
    hist = "improved_training_history.json"
    assert (json.loads((full / hist).read_text())
            == json.loads((part / hist).read_text()))
