"""Family B with the attention temporal encoder in the port, against
`cvad_tpu` on the CPU: the model (eval and train-mode BatchNorm), 1 and 8
train steps (the memory bank included), the state-dict round trip, the
parameter count and initialisation of the flash configuration, the bank
width, and `cli train` with the attention encoder followed by its scorer.

The narrow config keeps the structure (the encoder and decoder of
tests/test_torch_port_family_b.py, one attention block of 2 heads over the
32-wide latent, T=16).  On the CPU `cvad_tpu` takes its jnp attention, and
the port its plain version.
"""

import functools
import json

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import FamilyBConfig, preset
from cvad_tpu_torch.models import MemoryVideoAutoEncoder
from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_b,
                                               from_jax_opt_state,
                                               to_jax_family_b)
from cvad_tpu_torch.train.tasks import bn_absorbed_biases, build_task

NARROW = dict(conv_channels=(8, 16, 32, 32), latent_dim=32, memory_size=16,
              temporal_encoder="attention", attn_heads=2, attn_layers=1)
# bench.py's flash configuration (measure_flash_attention): the kernel's
# shapes, one 128-wide head, T=128
FLASH = dict(temporal_encoder="attention", latent_dim=128, attn_heads=1)
T, B, STEPS = 16, 4, 8
LR = 1e-5  # as tests/test_torch_port_train_b.py: the updates exceed PARAM_ATOL
PARAM_ATOL = 2e-5


def _jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    return jax


def _cfg(**model):
    cfg = preset("memory_ae")
    return cfg.replace(model=FamilyBConfig(**{**NARROW, **model}),
                       data=cfg.data.replace(clip_len=T),
                       optim=cfg.optim.replace(lr=LR))


@functools.lru_cache(maxsize=None)
def _jax_task():
    _jax()
    from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig
    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.train.tasks import build_task as jax_build_task

    jcfg = jax_preset("memory_ae")
    return jax_build_task(jcfg.replace(
        model=JaxFamilyBConfig(**NARROW),
        data=jcfg.data.replace(clip_len=T),
        optim=jcfg.optim.replace(lr=LR)))


def _stream():
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (STEPS, B, T, 64, 64, 1), dtype=np.uint8)
    labels = (rng.uniform(size=(STEPS, B)) < 0.25).astype(np.float32)
    return clips, labels


@pytest.fixture(scope="module")
def jax_run():
    """`cvad_tpu`'s family-B train step with the attention encoder over the
    stream: the initial state, the states after steps 1 and STEPS, and every
    step's metrics.  The BatchNorm and LayerNorm scales and biases, the
    attention denses' biases and the running statistics of the initial
    state are drawn at random so that nothing sits at its initial value
    (the conv biases that feed a BatchNorm stay 0: they get no gradient,
    and a large mean in front of BatchNorm's E[x^2] - E[x]^2 only
    magnifies the two frameworks' rounding)."""
    jax = _jax()
    import jax.numpy as jnp

    task = _jax_task()
    clips, labels = _stream()
    state = task.init_state(jax.random.key(0),
                            {"clips": jnp.asarray(clips[0])})
    rng = np.random.default_rng(1)

    def perturb(path, a):
        names = [getattr(p, "key", "") for p in path]
        name = names[-1]
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias" and ("temporal" in names
                               or names[-2].startswith("bn_")) \
                or name == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return np.asarray(a)

    state = state.replace(
        params=jax.tree_util.tree_map_with_path(perturb, state.params),
        batch_stats=jax.tree_util.tree_map_with_path(perturb,
                                                     state.batch_stats))
    out = {"init": jax.device_get(state), "metrics": []}
    step = jax.jit(task.train_step)
    with jax.default_matmul_precision("highest"):
        for i in range(STEPS):
            state, m = step(state, {"clips": jnp.asarray(clips[i]),
                                    "labels": jnp.asarray(labels[i])},
                            jax.random.key(1))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i + 1 in (1, STEPS - 1, STEPS):
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


def _bank(m, d, fill, seed=3):
    rng = np.random.default_rng(seed)
    memory = np.zeros((m, d), np.float32)
    memory[:fill] = rng.normal(size=(fill, d))
    return memory, np.int32(fill % m), np.int32(fill)


@pytest.mark.parametrize("method,train", [("__call__", False),
                                          ("folded_forward", True)])
def test_attention_model_matches_jax(jax_run, method, train):
    """The model at T=16, B=2 with a partly filled bank: outputs within 1e-5
    in eval mode and 2e-5 with train-mode BatchNorm (the family-B
    tolerances, tests/test_torch_port_family_b.py), and the new running
    statistics."""
    jax = _jax()
    import jax.numpy as jnp

    from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig
    from cvad_tpu.models import family_b as jfb

    js = jax_run["init"]
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    bank = _bank(16, 32, 12)
    model = jfb.MemoryVideoAutoEncoder(JaxFamilyBConfig(**NARROW))
    clips = np.random.default_rng(2).uniform(
        0, 1, (2, T, 64, 64, 1)).astype(np.float32)
    port = MemoryVideoAutoEncoder(FamilyBConfig(**NARROW)).train(train)
    port.load_state_dict(from_jax_family_b(variables, bank), strict=True)
    x = torch.from_numpy(np.ascontiguousarray(clips.transpose(0, 1, 4, 2, 3)))
    jbank = jfb.MemoryBankState(*(jnp.asarray(v) for v in bank))
    with jax.default_matmul_precision("highest"):
        if method == "__call__":
            ref, mutated = jax.jit(lambda v, c, m: model.apply(
                v, c, m, train=train, mutable=["batch_stats"]))(
                    variables, jnp.asarray(clips), jbank)
            got = port(x)
            want = np.asarray(ref["reconstructed"]).transpose(0, 1, 4, 2, 3)
            frame = got["reconstructed"]
        else:
            flat = jnp.asarray(clips.reshape((2 * T, 64, 64, 1)))
            ref, mutated = jax.jit(lambda v, c, m: model.apply(
                v, c, m, t=T, train=train, mutable=["batch_stats"],
                method="folded_forward"))(variables, flat, jbank)
            got = port.folded_forward(x.reshape(2 * T, 1, 64, 64),
                                      port.memory_bank(), t=T)
            want = np.asarray(ref["recon_frame"]).transpose(0, 3, 1, 2)
            frame = got["recon_frame"]
    atol = 2e-5 if train else 1e-5
    np.testing.assert_allclose(frame.detach().numpy(), want, rtol=0,
                               atol=atol)
    for k in ("sequence_feature", "frame_features", "anomaly_score"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)
    assert got["sequence_feature"].shape == (2, 32)
    want_sd = from_jax_family_b({"params": js.params,
                                 "batch_stats": mutated["batch_stats"]})
    for k, v in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(port.state_dict()[k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_steps_match_jax(jax_run, steps):
    """Every step's loss and normal count, then the parameters (attention
    included), the BatchNorm statistics, both Adam moments and the 32-wide
    bank (rows, ptr, fill; it wraps at step 5), with the tolerances of
    tests/test_torch_port_train_b.py: XLA's CPU float32 reductions through
    BatchNorm's backward move the first conv blocks' gradients by ~0.2% of
    their largest entry.

    The bank's rows are LayerNorm'd sequence features (entries up to ~4),
    each written by the train-mode forward of its own step.  The rows of
    the last step, taken from `cvad_tpu`'s state before it, are held to
    train_b's 5e-5; the rows of the whole run also carry the parameters'
    drift (3.6e-6 after 8 steps, measured), which the forward through four
    train-mode BatchNorms and the LayerNorms magnifies ~100x: within
    1e-3."""
    task = build_task(_cfg())
    state = _port_state(task, jax_run["init"])
    clips, labels = _stream()
    for i in range(steps):
        state, m = task.train_step(state, {
            "clips": torch.from_numpy(clips[i]),
            "labels": torch.from_numpy(labels[i])}, 1)
        ref = jax_run["metrics"][i]
        assert float(m["n_normal"]) == ref["n_normal"]
        np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-5,
                                   atol=1e-7, err_msg=f"step {i}")
    js = jax_run[steps]
    want = from_jax_family_b({"params": js.params,
                              "batch_stats": js.batch_stats}, js.extra)
    got = state.model.state_dict()
    init = from_jax_family_b({"params": jax_run["init"].params})
    moved = max(float((want[k] - init[k]).abs().max())
                for k in init if k.startswith("temporal."))
    assert moved > (2 * PARAM_ATOL if steps == STEPS else 0.5 * LR)
    for k, _ in state.model.named_parameters():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=2e-5, err_msg=k)
    assert got["normal_memory"].shape == (16, 32)
    np.testing.assert_allclose(got["normal_memory"].numpy(),
                               want["normal_memory"].numpy(), rtol=0,
                               atol=5e-5 if steps == 1 else 1e-3)
    last, _ = task.train_step(
        _port_state(task, jax_run[steps - 1] if steps > 1
                    else jax_run["init"]),
        {"clips": torch.from_numpy(clips[steps - 1]),
         "labels": torch.from_numpy(labels[steps - 1])}, 1)
    np.testing.assert_allclose(last.model.normal_memory.numpy(),
                               want["normal_memory"].numpy(), rtol=0,
                               atol=5e-5)
    assert int(got["memory_ptr"]) == int(want["memory_ptr"])
    assert int(got["memory_fill"]) == int(want["memory_fill"])
    if steps == STEPS:
        assert int(got["memory_fill"]) == 16  # the ring wrapped
    jopt = from_jax_opt_state(js.opt_state, state.model,
                              convert=from_jax_family_b)
    for name, tol in (("mu", 5e-3), ("nu", 2e-3)):
        ours, theirs = getattr(state.opt_state, name), getattr(jopt, name)
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=0,
                                   atol=tol * float(theirs.abs().max()),
                                   err_msg=name)
    assert int(state.opt_state.count) == int(jopt.count) == steps


def test_state_dict_round_trips_through_jax_layout(jax_run):
    js = jax_run[STEPS]
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    bank = tuple(np.asarray(v) for v in js.extra)
    back, mem = to_jax_family_b(from_jax_family_b(variables, bank))
    jax = _jax()
    leaves = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in leaves(back)] == [p for p, _ in leaves(variables)]
    for (_, a), (_, b) in zip(leaves(back), leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(mem, bank):
        np.testing.assert_array_equal(a, b)


def test_flash_config_param_count_and_bank_width():
    """bench.py's flash configuration has 2,302,273 parameters on both
    sides; its bank is (500, 128), as wide as the attention encoder's
    sequence feature (the LSTM width would be 64), and a train step writes
    128-wide rows into it.  The attention biases are not BN-absorbed."""
    jax = _jax()
    import jax.numpy as jnp

    from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig
    from cvad_tpu.models import family_b as jfb

    jmodel = jfb.MemoryVideoAutoEncoder(JaxFamilyBConfig(**FLASH))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 128, 64, 64, 1)),
        jfb.init_memory(500, 128), train=True))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    cfg = preset("memory_ae")
    cfg = cfg.replace(model=FamilyBConfig(**FLASH),
                      data=cfg.data.replace(clip_len=8))
    task = build_task(cfg)
    state = task.init_state(0, "cpu")
    model = state.model
    assert sum(p.numel() for p in model.parameters()) == n_jax == 2302273
    assert model.memory_bank().memory.shape == (500, 128)
    assert not [n for n in bn_absorbed_biases(model) if "temporal" in n]
    clips = np.random.default_rng(4).integers(0, 256, (3, 8, 64, 64, 1),
                                              dtype=np.uint8)
    labels = np.array([0, 1, 0], np.float32)
    state, m = task.train_step(state, {"clips": torch.from_numpy(clips),
                                       "labels": torch.from_numpy(labels)}, 0)
    bank = model.memory_bank()
    assert int(bank.fill) == int(bank.ptr) == 2 == int(m["n_normal"])
    rows = bank.memory[:2]
    assert bool((rows.abs().sum(1) > 0).all()) and not bank.memory[2:].any()
    with torch.no_grad():
        seq, _ = model.eval().encode_sequence(
            torch.from_numpy(clips[[0, 2]]).float().div(255)
            .clamp(1e-3, 0.999).permute(0, 1, 4, 2, 3))
    assert seq.shape == rows.shape == (2, 128)


def test_attention_denses_take_flax_init():
    """The attention denses are lecun-normal truncated at 2 std with zero
    bias (flax's default, as `cvad_tpu` initialises them), not the
    reference's xavier_normal(0.5) that the encoder and decoder denses
    keep; the position table is N(0, 0.02^2); LayerNorms start at 1 / 0.
    The spreads are held against `cvad_tpu`'s initialisation too."""
    jax = _jax()
    import jax.numpy as jnp

    from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig
    from cvad_tpu.models import family_b as jfb

    model = MemoryVideoAutoEncoder(FamilyBConfig(**FLASH), seed=0)
    jparams = jax.device_get(jax.jit(lambda k: jfb.MemoryVideoAutoEncoder(
        JaxFamilyBConfig(**FLASH)).init(
            k, jnp.zeros((1, 8, 64, 64, 1)), jfb.init_memory(500, 128),
            train=True))(jax.random.key(0)))["params"]
    block = model.temporal.block_0
    for name in ("qkv", "proj", "mlp_0", "mlp_2"):
        dense = getattr(block, name)
        fan_in, fan_out = dense.weight.shape[1], dense.weight.shape[0]
        lecun = fan_in ** -0.5
        xavier = 0.5 * (2.0 / (fan_in + fan_out)) ** 0.5
        std = dense.weight.std().item()
        jstd = float(np.std(jparams["temporal"]["block_0"][name]["kernel"]))
        assert abs(std - lecun) < 0.05 * lecun, (name, std, lecun)
        assert abs(std - jstd) < 0.05 * lecun, (name, std, jstd)
        assert abs(std - xavier) > 0.2 * lecun, name
        assert dense.weight.abs().max().item() <= 2 * lecun / 0.8796 + 1e-6
        assert not dense.bias.any()
    assert abs(model.temporal.pos_embed.std().item() - 0.02) < 1e-3
    for ln in (block.ln1, block.ln2, model.temporal.ln_out):
        assert bool((ln.weight == 1).all()) and not ln.bias.any()
    fc = model.encoder[13].weight
    assert abs(fc.std().item() - 0.5 * (2.0 / sum(fc.shape)) ** 0.5) < 1e-3


def test_cli_train_attention_and_score(tmp_path, capsys):
    """``cli train --preset memory_ae`` with the attention encoder (narrowed
    with --set) writes a best checkpoint holding the ``temporal.*`` keys;
    `make_family_b_score_fn(cfg=...)` of it scores within 1e-5 of the eval
    step."""
    from cvad_tpu_torch import cli
    from cvad_tpu_torch.config import ExperimentConfig
    from cvad_tpu_torch.evaluation.scoring import make_family_b_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    out = tmp_path / "run"
    sets = ["model.temporal_encoder=attention", "model.latent_dim=32",
            "model.attn_heads=2", "model.attn_layers=1",
            "model.conv_channels=8,16,32,32", "model.memory_size=16",
            f"data.clip_len={T}", "data.batch_size=4"]
    assert cli.main(["train", "--preset", "memory_ae", "--epochs", "1",
                     "--n-synthetic", "8", "--device", "cpu", "--out",
                     str(out), *sum((["--set", s] for s in sets), [])]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["epochs"] == 1 and np.isfinite(res["final_loss"])
    saved = json.loads((out / "config.json").read_text())["model"]
    assert saved["temporal_encoder"] == "attention"
    state = load_torch_state_dict(str(out / "checkpoints/best/model.pth"))
    assert "temporal.block_0.qkv.weight" in state
    assert state["normal_memory"].shape == (16, 32)
    cfg = FamilyBConfig(**{**saved, "conv_channels": tuple(
        saved["conv_channels"])})
    clips = np.random.default_rng(5).uniform(
        0.001, 0.999, (3, T, 64, 64, 1)).astype(np.float32)
    got = make_family_b_score_fn(state, cfg=cfg, device="cpu")(clips)
    task = build_task(ExperimentConfig(model=cfg))
    st = task.init_state(0, "cpu")
    st.model.load_state_dict(state, strict=True)
    want = task.eval_step(st, {"clips": torch.from_numpy(clips),
                               "labels": torch.zeros(3)})["predictions"]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
