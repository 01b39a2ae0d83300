"""Family B's model in the port against `cvad_tpu`'s on the CPU: the
forward (``__call__`` and ``folded_forward``, train and eval mode, with a
partly filled bank), `MaskedBatchNorm`, the memory-bank updates across a
wraparound, the parameter count, checkpoints both ways, and bf16.

Weights are made in JAX and carried across with `from_jax_family_b`: the two
frameworks draw different numbers from the same seed.  The narrow config
keeps the published structure at a fraction of the width.  JAX runs under
``jax.default_matmul_precision("highest")``.
"""

import functools

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # cvad_tpu's package imports
import jax.numpy as jnp  # noqa: E402

from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig  # noqa: E402
from cvad_tpu.models import family_b as jfb  # noqa: E402
from cvad_tpu.models.layers import MaskedBatchNorm as JaxBN  # noqa: E402
from cvad_tpu.train.tasks import \
    update_memory_masked as jax_update_masked  # noqa: E402
from cvad_tpu_torch.config import FamilyBConfig  # noqa: E402
from cvad_tpu_torch.models.family_b import (  # noqa: E402
    MemoryBankState, MemoryVideoAutoEncoder, _LSTM, init_memory,
    update_memory)
from cvad_tpu_torch.models.layers import MaskedBatchNorm  # noqa: E402
from cvad_tpu_torch.runtime.checkpoint import (  # noqa: E402
    from_jax_family_b, to_jax_family_b)
from cvad_tpu_torch.train.tasks import update_memory_masked  # noqa: E402

NARROW = dict(conv_channels=(8, 16, 32, 32), latent_dim=16, lstm_hidden=16,
              memory_size=32)
B, T = 3, 8
FILL = 20  # slots filled of the narrow bank's 32


def _apply(model, variables, *args, **kw):
    """`model.apply` under `jax.jit` (eager flax takes seconds a call)."""
    return jax.jit(lambda v, *a: model.apply(v, *a, **kw))(variables, *args)


@functools.lru_cache(maxsize=None)
def _jax_variables(jcfg, seed=0):
    """`cvad_tpu`'s init, then every BatchNorm scale, bias and running
    statistic and every conv bias drawn at random, so that nothing sits at
    its initial value.  Cached: callers do not modify them."""
    model = jfb.MemoryVideoAutoEncoder(jcfg)
    mem = jfb.init_memory(jcfg.memory_size, jcfg.latent_dim)
    clips = jnp.zeros((1, T, 64, 64, 1), jnp.float32)
    variables = jax.device_get(jax.jit(
        lambda k: model.init(k, clips, mem, train=True))(
            jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)

    def perturb(path, v):
        names = [getattr(k, "key", "") for k in path]
        if names[-1] in ("scale",):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if names[-1] in ("bias", "mean"):
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        if names[-1] == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return np.asarray(v)

    return model, jax.tree_util.tree_map_with_path(perturb, variables)


def _bank(jcfg, fill=FILL, seed=3):
    rng = np.random.default_rng(seed)
    memory = np.zeros((jcfg.memory_size, jcfg.latent_dim), np.float32)
    memory[:fill] = rng.normal(size=(fill, jcfg.latent_dim))
    return (memory, np.int32(fill % jcfg.memory_size), np.int32(fill))


def _port_model(variables, bank, **cfg):
    model = MemoryVideoAutoEncoder(FamilyBConfig(**cfg))
    model.load_state_dict(from_jax_family_b(variables, bank), strict=True)
    return model


def _clips(n=B, seed=2):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, T, 64, 64, 1)).astype(np.float32)


def _to_port(x):  # (B, T, H, W, C) -> (B, T, C, H, W)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))


def _stats(params, batch_stats):
    """BatchNorm running statistics keyed like the port's state dict."""
    sd = from_jax_family_b({"params": params, "batch_stats": batch_stats})
    return {k: v for k, v in sd.items() if "running" in k}


def _check_outputs(got, ref, atol, frame_key="reconstructed"):
    if frame_key == "reconstructed":
        want = np.asarray(ref["reconstructed"]).transpose(0, 1, 4, 2, 3)
    else:
        want = np.asarray(ref["recon_frame"]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got[frame_key].detach().numpy(), want,
                               rtol=0, atol=atol)
    for k in ("sequence_feature", "frame_features", "anomaly_score"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("valid", [None, [1.0, 0.0, 1.0]])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("method", ["__call__", "folded_forward"])
def test_forward_matches_jax(method, train, valid):
    """Outputs with a partly filled bank, and in train mode the new
    BatchNorm running statistics (``valid`` masks rows out of them).
    Outputs within 1e-5 in eval mode; 2e-5 in train mode, where BatchNorm
    divides by the batch's own standard deviation, taken as E[x^2] - E[x]^2
    in float32 over sums in another order than XLA's, and so scales both
    frameworks' rounding up (measured 1.2e-5 on the tanh latent)."""
    jcfg = JaxFamilyBConfig(**NARROW)
    model, variables = _jax_variables(jcfg)
    bank = _bank(jcfg)
    jbank = jfb.MemoryBankState(*(jnp.asarray(v) for v in bank))
    clips = _clips()
    jvalid = None if valid is None else jnp.asarray(valid, jnp.float32)
    port = _port_model(variables, bank, **NARROW).train(train)
    pvalid = None if valid is None else torch.tensor(valid)
    kw = dict(train=train, valid=jvalid)
    with jax.default_matmul_precision("highest"):
        if method == "__call__":
            ref, mutated = _apply(model, variables, jnp.asarray(clips),
                                  jbank, mutable=["batch_stats"], **kw)
            got = port(_to_port(clips), valid=pvalid)
        else:
            flat = jnp.asarray(clips.reshape((B * T,) + clips.shape[2:]))
            ref, mutated = _apply(model, variables, flat, jbank, t=T,
                                  mutable=["batch_stats"],
                                  method="folded_forward", **kw)
            got = port.folded_forward(
                _to_port(clips).reshape((B * T, 1, 64, 64)),
                port.memory_bank(), t=T, valid=pvalid)
    _check_outputs(got, ref, 2e-5 if train else 1e-5,
                   "reconstructed" if method == "__call__" else "recon_frame")
    want = _stats(variables["params"], (mutated if train else variables)
                  ["batch_stats"])
    for k, v in want.items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_full_width_forward_matches_jax():
    """The published widths (32/64/128/128, latent 64, memory 500), eval
    mode, 2 clips."""
    jcfg = JaxFamilyBConfig()
    model, variables = _jax_variables(jcfg, seed=4)
    bank = _bank(jcfg, fill=300)
    clips = _clips(2, seed=5)
    with jax.default_matmul_precision("highest"):
        ref = _apply(model, variables, jnp.asarray(clips),
                     jfb.MemoryBankState(*(jnp.asarray(v) for v in bank)))
    port = _port_model(variables, bank).eval()
    with torch.no_grad():
        got = port(_to_port(clips))
    _check_outputs(got, ref, 1e-5)
    assert port.memory_bank().fill.item() == 300


def test_bf16_matches_jax_bf16():
    """dtype='bfloat16' on both sides (convs and denses in bf16; BatchNorm
    statistics, the latent, the LSTM and the memory in float32).  Tolerance
    3e-2: bf16 keeps 8 bits, and the frameworks round the conv sums at
    other places."""
    jcfg = JaxFamilyBConfig(**NARROW, dtype="bfloat16")
    model, variables = _jax_variables(jcfg)
    bank = _bank(jcfg)
    clips = _clips()
    ref = _apply(model, variables, jnp.asarray(clips),
                 jfb.MemoryBankState(*(jnp.asarray(v) for v in bank)))
    port = _port_model(variables, bank, **NARROW, dtype="bfloat16").eval()
    with torch.no_grad():
        got = port(_to_port(clips))
    assert got["reconstructed"].dtype == torch.float32
    _check_outputs(got, ref, 3e-2)


@pytest.mark.parametrize("valid", [None, [1.0, 0.0, 1.0, 1.0]])
def test_masked_batchnorm_matches_jax(valid):
    """Output and running statistics after one train-mode call, bf16 input
    too (statistics in float32); eval mode on the running statistics."""
    rng = np.random.default_rng(9)
    x = rng.normal(1.0, 2.0, (4, 5, 6, 7)).astype(np.float32)  # NHWC
    bn = JaxBN()
    v = bn.init(jax.random.key(0), jnp.asarray(x), train=True)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32),
                    "bias": rng.normal(size=7).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=7).astype(np.float32),
                         "var": rng.uniform(1, 2, 7).astype(np.float32)}}
    jvalid = None if valid is None else jnp.asarray(valid)
    pvalid = None if valid is None else torch.tensor(valid)
    port = MaskedBatchNorm(7)
    port.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for dtype, atol in ((jnp.float32, 1e-5), (jnp.bfloat16, 3e-2)):
        ref, mutated = bn.apply(v, jnp.asarray(x, dtype), train=True,
                                valid=jvalid, mutable=["batch_stats"])
        p = MaskedBatchNorm(7)
        p.load_state_dict(port.state_dict())
        got = p.train()(xt.to(getattr(torch, jnp.dtype(dtype).name)),
                        valid=pvalid)
        np.testing.assert_allclose(
            got.float().detach().numpy().transpose(0, 2, 3, 1),
            np.asarray(ref, np.float32), rtol=0, atol=atol)
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(p, ours).numpy(),
                np.asarray(mutated["batch_stats"][theirs]), rtol=1e-6,
                atol=1e-6)
        assert int(p.num_batches_tracked) == 1
    ref = bn.apply(v, jnp.asarray(x), train=False)
    got = port.eval()(xt)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=0, atol=1e-5)


def _assert_bank(got: MemoryBankState, ref):
    np.testing.assert_array_equal(got.memory.numpy(), np.asarray(ref.memory))
    assert int(got.ptr) == int(ref.ptr) and int(got.fill) == int(ref.fill)


def test_memory_updates_match_jax_across_wraparound():
    """`update_memory` (every row) and `update_memory_masked` (the masked
    rows packed first, in order) over writes that wrap the ring twice."""
    m, d = 10, 4
    rng = np.random.default_rng(11)
    ours, theirs = init_memory(m, d), jfb.init_memory(m, d)
    ours_m, theirs_m = init_memory(m, d), jfb.init_memory(m, d)
    for step in range(7):
        feats = rng.normal(size=(6, d)).astype(np.float32)
        mask = (rng.uniform(size=6) < 0.6).astype(np.float32)
        if step == 3:
            mask[:] = 0.0  # nothing to write: the bank stays as it was
        ours = update_memory(ours, torch.from_numpy(feats))
        theirs = jfb.update_memory(theirs, jnp.asarray(feats))
        _assert_bank(ours, theirs)
        ours_m = update_memory_masked(ours_m, torch.from_numpy(feats),
                                      torch.from_numpy(mask))
        theirs_m = jax_update_masked(theirs_m, jnp.asarray(feats),
                                     jnp.asarray(mask))
        _assert_bank(ours_m, theirs_m)
    assert int(ours.fill) == m and int(ours_m.fill) == m
    assert ours.ptr.dtype == ours.fill.dtype == torch.int32


def test_param_count_matches_jax():
    """One LSTM bias per gate, as flax: the same 1,152,001 parameters."""
    jcfg = JaxFamilyBConfig()
    model = jfb.MemoryVideoAutoEncoder(jcfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0),
                           jnp.zeros((1, T, 64, 64, 1)),
                           jfb.init_memory(500, 64), train=True))
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    port = MemoryVideoAutoEncoder()
    assert sum(p.numel() for p in port.parameters()) == n_jax == 1152001


def test_unknown_temporal_encoder_is_refused():
    with pytest.raises(ValueError, match="temporal_encoder='gru'"):
        FamilyBConfig(temporal_encoder="gru")


def test_state_dict_round_trips_through_jax_layout():
    jcfg = JaxFamilyBConfig(**NARROW)
    _, variables = _jax_variables(jcfg)
    bank = _bank(jcfg, fill=32)
    bank = (bank[0], np.int32(5), np.int32(32))  # a wrapped bank
    sd = from_jax_family_b(variables, bank)
    back, mem = to_jax_family_b(sd)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(mem, bank):
        np.testing.assert_array_equal(a, b)
    model = _port_model(variables, bank, **NARROW)
    assert model.memory_bank().fill.item() == 32
    assert model.memory_bank().ptr.item() == 5


def test_port_checkpoint_read_by_import_torch_family_b(tmp_path):
    """A port checkpoint, saved with `torch.save` as the trainer saves it
    (``{"model_state_dict": ...}``), is read by `cvad_tpu`'s
    `import_torch_family_b` unchanged, and scores the same in JAX as in the
    port.  The bank has not wrapped, so the reference's fill (= ptr) is the
    port's."""
    from cvad_tpu.evaluation.scoring import \
        make_family_b_score_fn as jax_score_fn
    from cvad_tpu.runtime.checkpoint import import_torch_family_b

    from cvad_tpu_torch.evaluation.scoring import make_family_b_score_fn

    jcfg = JaxFamilyBConfig(**NARROW)
    model, variables = _jax_variables(jcfg, seed=6)
    port = _port_model(variables, _bank(jcfg), **NARROW)
    path = tmp_path / "model.pth"
    torch.save({"model_state_dict": port.state_dict(), "step": 3}, path)
    jvars, jmem = import_torch_family_b(str(path))
    assert int(jmem.fill) == int(jmem.ptr) == FILL
    clips = _clips(4, seed=8)
    with jax.default_matmul_precision("highest"):
        ref = jax_score_fn(jvars, jmem, model=model)(clips)
    got = make_family_b_score_fn(port.state_dict(), cfg=FamilyBConfig(
        **NARROW), device="cpu")(clips)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    u8 = (clips * 255).astype(np.uint8)
    with jax.default_matmul_precision("highest"):
        ref8 = jax_score_fn(jvars, jmem, model=model)(u8)
    np.testing.assert_allclose(make_family_b_score_fn(
        port.state_dict(), cfg=FamilyBConfig(**NARROW), device="cpu")(u8),
        ref8, rtol=0, atol=1e-5)


def test_reference_state_dict_loads_strictly():
    """A reference ``VideoAutoEncoder`` state dict: torch's two LSTM biases,
    ``num_batches_tracked`` and no ``memory_fill``.  It loads strictly; the
    port holds the biases' sum and fill = ptr, and its cell gives
    `torch.nn.LSTM`'s last hidden state."""
    port = MemoryVideoAutoEncoder(FamilyBConfig(**NARROW), seed=1)
    ref = {k: v.clone() for k, v in port.state_dict().items()
           if k != "memory_fill"}
    rng = np.random.default_rng(12)
    lstm = nn.LSTM(16, 16, batch_first=True)
    for name, p in lstm.named_parameters():
        p.data = torch.from_numpy(rng.normal(0, 0.3, p.shape)
                                  .astype(np.float32))
        ref[f"temporal_encoder.{name}"] = p.data.clone()
    ref["memory_ptr"] = torch.tensor([7])
    ref["encoder.1.num_batches_tracked"] = torch.tensor(12)
    port.load_state_dict(ref, strict=True)
    sd = port.state_dict()
    torch.testing.assert_close(sd["temporal_encoder.bias_ih_l0"],
                               ref["temporal_encoder.bias_ih_l0"]
                               + ref["temporal_encoder.bias_hh_l0"])
    assert not sd["temporal_encoder.bias_hh_l0"].any()
    assert port.memory_bank().fill.item() == port.memory_bank().ptr.item() == 7
    z = torch.from_numpy(rng.normal(size=(5, T, 16)).astype(np.float32))
    with torch.no_grad():
        _, (h_n, _) = lstm(z)
        torch.testing.assert_close(port.temporal_encoder(z), h_n[0],
                                   rtol=0, atol=1e-6)
    assert isinstance(port.temporal_encoder, _LSTM)
