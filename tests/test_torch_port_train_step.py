"""Family D's train step in the port against `cvad_tpu` on the CPU: the
optimizer against optax, the schedulers against `cvad_tpu`'s, 1 and 20
train steps from the same parameters and optimizer state, and the NaN
guard.

The frameworks cannot share random draws: the step tests set dropout to 0
and pass the labels in as ``pseudo_targets``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # cvad_tpu's package imports
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cvad_tpu.config import OptimConfig as JaxOptimConfig  # noqa: E402
from cvad_tpu.config import preset as jax_preset  # noqa: E402
from cvad_tpu.train import optim as jo  # noqa: E402
from cvad_tpu.train.tasks import build_task as jax_build_task  # noqa: E402
from cvad_tpu_torch.config import OptimConfig, preset  # noqa: E402
from cvad_tpu_torch.runtime.checkpoint import (  # noqa: E402
    from_jax_family_d, from_jax_opt_state)
from cvad_tpu_torch.train import optim as po  # noqa: E402
from cvad_tpu_torch.train.tasks import build_task  # noqa: E402

B, HW, STEPS = 8, 16, 20
# Adam's first steps are close to lr * sign(g): where a gradient entry is
# near 0, the two frameworks' rounding of it (f32 sums in another order)
# can move that parameter by up to ~lr per step.  2e-5 is 4% of lr = 5e-4.
PARAM_ATOL = 2e-5

OPTIMS = {
    "adamw_clip": dict(),
    "adamw_noclip": dict(grad_clip=0.0),
    "adam_coupled_conditional": dict(optimizer="adam", lr=1e-3,
                                     weight_decay=1e-5, grad_clip=1.0,
                                     clip_trigger=10.0),
    "adam_plain": dict(optimizer="adam", weight_decay=0.0, grad_clip=0.0),
}


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_optimizer_matches_optax(name):
    """5 updates on a random tree with gradients below and above the clip
    thresholds: parameters, both moments and the count agree."""
    kw = OPTIMS[name]
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(0, scale, s).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.05, 1.0, 8.0, 0.2,
                                                        3.0)]
    keys = sorted(shapes)

    tx = jo.build_optimizer(JaxOptimConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)

    opt = po.build_optimizer(OptimConfig(**kw))
    flat = po.flatten(torch.from_numpy(params[k]) for k in keys)
    st = opt.init(flat)
    for g in grads:
        upd, st = opt.update(po.flatten(torch.from_numpy(g[k]) for k in keys),
                             st, flat)
        flat = flat + upd

    def leaves(tree):
        return np.concatenate([np.asarray(tree[k]).ravel() for k in keys])

    adam = [s for s in jax.tree_util.tree_leaves(
        js, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    np.testing.assert_allclose(flat.numpy(), leaves(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(st.mu.numpy(), leaves(adam.mu), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(st.nu.numpy(), leaves(adam.nu), rtol=1e-5,
                               atol=1e-10)
    assert int(st.count) == int(adam.count) == len(grads)


def test_injected_lr_roundtrip():
    """`set_lr` writes the learning rate into the state's own tensor (a
    captured train-step graph reads that tensor at every replay)."""
    opt = po.build_optimizer(OptimConfig(lr=5e-4))
    st = opt.init(torch.zeros(3))
    assert abs(po.get_lr(st) - 5e-4) < 1e-9
    lr = st.lr
    st2 = po.set_lr(st, 1e-5)
    assert st2 is st and st.lr is lr
    assert abs(po.get_lr(st2) - 1e-5) < 1e-9
    upd, _ = opt.update(torch.ones(3), st2, torch.zeros(3))
    assert torch.isfinite(upd).all()


@pytest.mark.parametrize("schedule,kw", [
    ("plateau", dict(plateau_patience=2, plateau_factor=0.5)),
    ("step", dict(step_size=3, step_gamma=0.7)),
    ("cosine", dict(cosine_steps=10)),
    ("constant", dict())])
def test_scheduler_matches_jax(schedule, kw):
    """Plain Python on both sides: the same lr sequence, exactly."""
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.6, 0.6, 0.7,
               float("nan"), 0.8, None, 0.9]
    ours = po.HostScheduler(OptimConfig(lr=0.1, schedule=schedule, **kw), 12)
    ref = jo.HostScheduler(JaxOptimConfig(lr=0.1, schedule=schedule, **kw), 12)
    for m in metrics:
        assert ours.step(m) == ref.step(m)
        assert ours.state_dict() == ref.state_dict()


def _configs():
    jcfg = jax_preset("family_d")
    jcfg = jcfg.replace(model=jcfg.model.replace(dropout=0.0),
                        data=jcfg.data.replace(frame_size=(HW, HW)))
    cfg = preset("family_d")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0),
                      data=cfg.data.replace(frame_size=(HW, HW)))
    return jcfg, cfg


def _stream():
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (STEPS, B, 8, HW, HW, 3), dtype=np.uint8)
    targets = (rng.uniform(size=(STEPS, B)) < 0.25).astype(np.float32)
    return clips, targets


@pytest.fixture(scope="module")
def jax_run():
    """`cvad_tpu`'s family-D train step for STEPS steps on uint8 batches
    with injected pseudo-labels: the initial state, the states after
    steps 1 and STEPS, and every step's metrics."""
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
            if i + 1 in (1, STEPS):
                out[i + 1] = jax.device_get(state)
    return out


def _port_state(task, jax_state):
    state = task.init_state(0, "cpu")
    state.model.load_state_dict(
        from_jax_family_d({"params": jax_state.params}), strict=True)
    state.opt_state = from_jax_opt_state(jax_state.opt_state, state.model)
    return state


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_step_matches_jax(jax_run, steps):
    """From the same parameters: every step's loss and components, then
    the parameters, both moments and Adam's count."""
    _, cfg = _configs()
    task = build_task(cfg)
    state = _port_state(task, jax_run["init"])
    clips, targets = _stream()
    for i in range(steps):
        state, m = task.train_step(
            state, {"clips": torch.from_numpy(clips[i]),
                    "pseudo_targets": torch.from_numpy(targets[i])}, 1)
        ref = jax_run["metrics"][i]
        assert sorted(m) == sorted(ref)
        for k in m:
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert state.step == steps
    js = jax_run[steps]
    jp = from_jax_family_d({"params": js.params})
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jp[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    jopt = from_jax_opt_state(js.opt_state, state.model)
    # moments: f32 rounding of gradients of size ~1e-2 (mu) and their
    # squares (nu)
    np.testing.assert_allclose(state.opt_state.mu.numpy(), jopt.mu.numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(state.opt_state.nu.numpy(), jopt.nu.numpy(),
                               rtol=1e-3, atol=1e-11)
    assert int(state.opt_state.count) == int(jopt.count) == steps
    assert float(state.opt_state.lr) == float(jopt.lr)


def test_non_finite_batch_is_skipped():
    """A NaN clip makes the loss non-finite: parameters, both moments and
    Adam's count stay as they were; the step advances."""
    _, cfg = _configs()
    task = build_task(cfg)
    state = task.init_state(0, "cpu")
    clips = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (4, 8, HW, HW, 3)).astype(np.float32))
    targets = torch.tensor([0.0, 1.0, 0.0, 0.0])
    state, _ = task.train_step(state, {"clips": clips,
                                       "pseudo_targets": targets}, 1)
    before = ({k: v.clone() for k, v in state.model.state_dict().items()},
              state.opt_state.mu.clone(), state.opt_state.nu.clone(),
              int(state.opt_state.count))
    bad = clips.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    state, m = task.train_step(state, {"clips": bad,
                                       "pseudo_targets": targets}, 1)
    assert not np.isfinite(float(m["loss"]))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    assert torch.equal(state.opt_state.mu, before[1])
    assert torch.equal(state.opt_state.nu, before[2])
    assert int(state.opt_state.count) == before[3] == 1
    assert state.step == 2


def test_bf16_flips_the_model_dtype_and_steps():
    """train.dtype='bfloat16' runs the conv stack and fc in bf16, as
    `cvad_tpu`'s tasks.py:97-98; parameters stay float32."""
    _, cfg = _configs()
    cfg = cfg.replace(train=cfg.train.replace(dtype="bfloat16"))
    task = build_task(cfg)
    assert task.model_cfg.dtype == "bfloat16"
    state = task.init_state(0, "cpu")
    clips = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 8, HW, HW, 3), dtype=np.uint8))
    p0 = state.params()[0].clone()
    state, m = task.train_step(state, {"clips": clips}, 1)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert state.params()[0].dtype == torch.float32
    assert not torch.equal(state.params()[0], p0)
