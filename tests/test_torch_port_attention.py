"""K6 and the attention encoder: the port's plain attention, its gradients,
the route table, the block and the encoder against `cvad_tpu`'s
(`cvad_tpu/ops/attention.py`) on the CPU, and the CUDA kernels against the
plain version on a card.

`cvad_tpu` runs here as `tests/test_attention.py` runs it: on the CPU its
attention takes the jnp path (``use_flash=False``; `flash_eligible` is
False off the TPU).  Weights are made in JAX and carried across with
`from_jax_temporal`.  JAX and `cvad_tpu` are imported inside the tests that
use them, so that the card tests run on a machine without flax.
"""

import numpy as np
import pytest
import torch

from cvad_tpu_torch.ops import attention as pa
from cvad_tpu_torch.ops import flash_attention as fa
from cvad_tpu_torch.runtime.checkpoint import (from_jax_temporal,
                                               to_jax_temporal)

# (B, H, T, Dh): the jnp path's shape in tests/test_attention.py, and the
# flash configuration's (one 128-wide head over 128 frames)
SHAPES = [(2, 2, 16, 32), (2, 1, 128, 128)]
# the kernels' card cases (B, H, T, Dh)
CARD_SHAPES = [(2, 1, 128, 128), (16, 1, 128, 128), (4, 2, 256, 128),
               (2, 1, 128, 256), (2, 1, 128, 512)]  # head dim: 1, 2, 4 chunks
# the kernels' tile edges: T = 64 (one tile) and T = 192 (no multiple of
# 128); B*H = 35 with 140 blocks of 64 rows, enough to take the 64-row
# blocks on a 132-SM card; head dim 384 (an output group of one chunk) and
# 640 (5 chunks: the block's own rows stream instead of being staged)
EDGE_SHAPES = [(1, 1, 64, 128), (2, 1, 192, 128), (5, 7, 256, 128),
               (3, 1, 192, 256), (1, 3, 64, 384), (1, 1, 64, 640)]


def _jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    return jax


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _np(t):
    return t.detach().numpy()


# -- the plain version and the autograd Function on the CPU ----------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_attention_and_grads_match_jax(shape, causal):
    """`attention_reference`, `multi_head_attention` and `flash_attention`
    (a CPU tensor takes the plain version) against `cvad_tpu`'s
    ``multi_head_attention(use_flash=False)``, and their gradients for a
    random cotangent against `jax.vjp` of it: within 1e-5."""
    jax = _jax()
    import jax.numpy as jnp

    from cvad_tpu.ops.attention import multi_head_attention as jax_mha

    q, k, v = _qkv(shape)
    ct = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, causal=causal,
                                                   use_flash=False),
                           *(jnp.asarray(x) for x in (q, k, v)))
        ref_grads = vjp(jnp.asarray(ct))
    scale = shape[3] ** -0.5
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    outs = {
        "reference": fa.attention_reference(tq, tk, tv, causal=causal,
                                            sm_scale=scale),
        "multi_head_attention": pa.multi_head_attention(tq, tk, tv,
                                                        causal=causal),
        "flash_attention": fa.flash_attention(tq, tk, tv, causal=causal,
                                              sm_scale=scale)}
    for name, out in outs.items():
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0,
                                   atol=1e-5, err_msg=name)
        grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct))
        for g, r, which in zip(grads, ref_grads, "qkv"):
            np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0,
                                       atol=1e-5, err_msg=f"{name} d{which}")


def test_cpu_function_is_the_plain_version_in_bf16():
    """bf16 inputs on the CPU: the Function's output is the plain version's
    bit for bit (f32 logits, weights cast to bf16 before the product with
    v), and no launch is counted."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv((2, 1, 128, 128)))
    before = (fa.flash_attention.launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    got = fa.flash_attention(q, k, v, causal=True, sm_scale=128 ** -0.5)
    ref = fa.attention_reference(q, k, v, causal=True, sm_scale=128 ** -0.5)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    assert (fa.flash_attention.launches, fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches) == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "dtype_mix"])
def test_flash_attention_rejects_what_it_does_not_take(bad):
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 1, 16, 32)))
    if bad == "shape":
        with pytest.raises(ValueError):
            fa.flash_attention(q, k[:, :, :8], v, sm_scale=1.0)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            fa.flash_attention(q.half(), k.half(), v.half(), sm_scale=1.0)
    else:
        with pytest.raises(TypeError):
            fa.flash_attention(q, k.double(), v, sm_scale=1.0)


def test_route_table_matches_jax(monkeypatch):
    """`flash_eligible` over T and head dims on the card and on the CPU
    against `cvad_tpu`'s with `_on_tpu` patched to True and to False (the
    TPU read as the CUDA card)."""
    _jax()
    import cvad_tpu.ops.attention as ja

    cases = [(t, dh) for t in (8, 16, 64, 100, 128, 192, 256, 384, 2048)
             for dh in (16, 32, 64, 96, 128, 256)]
    for on_card, device in ((True, "cuda"), (False, "cpu")):
        monkeypatch.setattr(ja, "_on_tpu", lambda v=on_card: v)
        for t, dh in cases:
            assert pa.flash_eligible(t, dh, device) == ja.flash_eligible(
                t, dh), (device, t, dh)
    assert pa.flash_eligible(128, 128, "cuda")
    assert not pa.flash_eligible(128, 16, "cuda")  # the default 64 / 4 heads


# -- the block and the encoder -----------------------------------------------


def _jax_module(kind, dim, heads, layers=2, causal=False, seed=0, t=16):
    """A `cvad_tpu` block or encoder and its parameters (numpy), with
    LayerNorm scales and biases and Dense biases drawn at random so that
    nothing sits at its initial value."""
    jax = _jax()
    import jax.numpy as jnp

    from cvad_tpu.ops import attention as ja

    mod = (ja.TemporalAttentionBlock(heads, causal=causal) if kind == "block"
           else ja.TemporalAttentionEncoder(layers, heads, causal=causal))
    params = jax.device_get(mod.init(jax.random.key(seed),
                                     jnp.zeros((1, t, dim))))["params"]
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return np.asarray(a)

    return mod, jax.tree_util.tree_map_with_path(perturb, params)


def _port_module(kind, dim, heads, params, layers=2, causal=False):
    mod = (pa.TemporalAttentionBlock(dim, heads, causal=causal)
           if kind == "block" else
           pa.TemporalAttentionEncoder(dim, layers, heads, causal=causal))
    mod.load_state_dict(from_jax_temporal(params), strict=True)
    return mod


@pytest.mark.parametrize("kind,dim,heads,t,causal", [
    ("block", 32, 2, 16, False), ("block", 32, 2, 16, True),
    ("encoder", 32, 2, 16, False), ("encoder", 128, 1, 128, True)])
def test_block_and_encoder_match_jax(kind, dim, heads, t, causal):
    """Outputs within 1e-5 on N(0, 1) latents; the encoder's is
    `ln_out` then the mean over T, (B, D)."""
    jax = _jax()
    import jax.numpy as jnp

    mod, params = _jax_module(kind, dim, heads, causal=causal, t=t)
    z = np.random.default_rng(2).normal(size=(3, t, dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, x: mod.apply({"params": p}, x))(
            params, jnp.asarray(z))
    port = _port_module(kind, dim, heads, params, causal=causal)
    with torch.no_grad():
        got = port(torch.from_numpy(z))
    assert got.shape == ref.shape == ((3, t, dim) if kind == "block"
                                      else (3, dim))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("trap", ["layernorm_eps", "gelu_tanh", "qkv_split",
                                  "pos_embed_rows"])
def test_flax_parity_traps(trap):
    """Each place where torch's default differs from flax's, held against
    `cvad_tpu` on its own: LayerNorm's epsilon (1e-6, not 1e-5) on rows of
    variance 1e-6; `nn.gelu`'s tanh approximation; the one qkv Dense split
    q | k | v along its outputs; the (4096, D) position table of which only
    the first T rows are read (the rest NaN here)."""
    jax = _jax()
    import flax.linen as nn
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    if trap == "layernorm_eps":
        x = (1e-3 * rng.normal(size=(4, 32))).astype(np.float32)
        ref = nn.LayerNorm().apply({"params": {"scale": np.ones(32, np.float32),
                                               "bias": np.zeros(32, np.float32)}},
                                   jnp.asarray(x))
        got = pa.TemporalAttentionBlock(32, 2).ln1(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                                   atol=1e-4)
        assert not np.allclose(_np(torch.nn.LayerNorm(32)(
            torch.from_numpy(x))), np.asarray(ref), atol=1e-2)
    elif trap == "gelu_tanh":
        x = np.linspace(-4, 4, 401, dtype=np.float32)
        ref = np.asarray(nn.gelu(jnp.asarray(x)))
        np.testing.assert_allclose(_np(pa.gelu(torch.from_numpy(x))), ref,
                                   rtol=0, atol=1e-6)
        exact = _np(torch.nn.functional.gelu(torch.from_numpy(x)))
        assert np.abs(exact - ref).max() > 1e-4
    elif trap == "qkv_split":
        _, params = _jax_module("block", 32, 2)
        x = rng.normal(size=(2, 16, 32)).astype(np.float32)
        dense = params["qkv"]
        ref = jnp.split(jnp.asarray(x) @ dense["kernel"] + dense["bias"], 3,
                        axis=-1)
        port = _port_module("block", 32, 2, params)
        assert port.qkv.weight.shape == (96, 32)
        with torch.no_grad():
            got = port.qkv(torch.from_numpy(x)).chunk(3, dim=-1)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0,
                                       atol=1e-5)
    else:
        mod, params = _jax_module("encoder", 32, 2)
        assert params["pos_embed"].shape == (4096, 32)
        z = rng.normal(size=(2, 16, 32)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            ref = mod.apply({"params": params}, jnp.asarray(z))
        port = _port_module("encoder", 32, 2, params)
        with torch.no_grad():
            port.pos_embed[16:] = float("nan")
            got = port(torch.from_numpy(z))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_temporal_tree_round_trips():
    _, params = _jax_module("encoder", 32, 2)
    back = to_jax_temporal(from_jax_temporal(params, "temporal."),
                           "temporal.")
    jax = _jax()
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- why float32 takes three TF32 products ------------------------------------


def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """float32 cut to TF32's 10 mantissa bits: to nearest with ties away
    from zero (how the kernels round the large part, as
    `cvt.rna.tf32.f32`), or toward zero (how the tensor cores read a float32
    register, the small part)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tc_product(a: torch.Tensor, b: torch.Tensor, terms: int
                ) -> torch.Tensor:
    """a @ b as the tensor cores take it from float32 operands: each split
    into big = tf32(x) and small = x - big, of which the tensor cores read
    10 bits; `terms` = 3 sums big.big + big.small + small.big, 1 only
    big.big; products and sums exact (float64), the result float32."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab.double() @ bb.double()
    if terms == 3:
        a_s, b_s = _tf32(a - ab, False), _tf32(b - bb, False)
        out = out + ab.double() @ b_s.double() + a_s.double() @ bb.double()
    return out.float()


def _attention_tc(q, k, v, do, causal, terms):
    """K6's forward and gradients with every product as `_tc_product`, the
    rest in float32: (o, dq, dk, dv)."""
    scale = q.shape[3] ** -0.5
    s = _tc_product(q, k.transpose(-1, -2), terms) * scale
    if causal:
        t = q.shape[2]
        s = s.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool)),
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = _tc_product(p, v, terms)
    d = (do * o).sum(-1, keepdim=True)
    ds = p * (_tc_product(do, v.transpose(-1, -2), terms) - d) * scale
    return (o, _tc_product(ds, k, terms),
            _tc_product(ds.transpose(-1, -2), q, terms),
            _tc_product(p.transpose(-1, -2), do, terms))


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_three_tf32_products_meet_the_float32_tolerances(shape):
    """The 3xTF32 split of K6's float32 products, emulated on the plain
    version's products, stays within `check_flash`'s float32 tolerances
    against the float32 plain version (forward within 1e-5, gradients
    within 1e-5 of the largest entry), causal and not; one TF32 product
    (big.big alone, TF32 as cuBLAS runs it) does not."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for _ in range(4))
    for causal in (False, True):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ref_o = fa.attention_reference(*xs, causal=causal,
                                       sm_scale=shape[3] ** -0.5)
        ref = (ref_o.detach(), *torch.autograd.grad(ref_o, xs, do))
        tols = [1e-5] + [1e-5 * r.abs().max().item() for r in ref[1:]]
        for terms in (3, 1):
            got = _attention_tc(q, k, v, do, causal, terms)
            errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
            within = [e <= tol for e, tol in zip(errs, tols)]
            if terms == 3:
                assert all(within), (causal, errs, tols)
            else:
                assert not any(within), (causal, errs, tols)


# -- the kernels on a card -------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")




def _card_case(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, ct = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .cuda().to(dtype) for _ in range(4))
    return q, k, v, ct


def _kernel_grads(q, k, v, ct, causal):
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*xs, causal=causal, sm_scale=q.shape[3] ** -0.5)
    return (out.detach(), *torch.autograd.grad(out, xs, ct))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_SHAPES + EDGE_SHAPES)
def test_kernels_match_plain_on_card(shape, dtype, causal):
    """Forward and dQ, dK, dV through the autograd Function against autograd
    through the plain version in float32 on the same (rounded) inputs:
    float32 forward within 1e-5, gradients within 1e-5 of the largest
    entry; bf16 within 2e-2 of the largest entry (bf16 rounding of P, dS
    and the outputs).  A second call is bit-identical and each counter rose
    by one a call."""
    _card()
    q, k, v, ct = _card_case(shape, dtype)
    before = (fa.flash_attention.launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    got = _kernel_grads(q, k, v, ct, causal)
    again = _kernel_grads(q, k, v, ct, causal)
    xs = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref_out = fa.attention_reference(*xs, causal=causal,
                                     sm_scale=shape[3] ** -0.5)
    ref = (ref_out.detach(),
           *torch.autograd.grad(ref_out, xs, ct.float()))
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.dq_launches - before[1],
            fa.flash_attention.dkv_launches - before[2]) == (2, 2, 2)
    for name, g, a, r in zip(("out", "dq", "dk", "dv"), got, again, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert torch.equal(g, a), f"{name}: second call differs"
        err = (g.float() - r).abs().max().item()
        if dtype == torch.float32:
            tol = 1e-5 if name == "out" else 1e-5 * r.abs().max().item()
        else:
            tol = 2e-2 * r.abs().max().item()
        assert err <= tol, f"{name}: max err {err} beyond {tol}"


@pytest.mark.cuda
def test_route_launches_on_card_only_where_eligible():
    """`multi_head_attention` launches K6 at (T, Dh) = (128, 128) and takes
    the plain expression at the default head dim (16)."""
    _card()
    q, k, v, _ = _card_case((2, 1, 128, 128), torch.float32)
    n = fa.flash_attention.launches
    pa.multi_head_attention(q, k, v)
    assert fa.flash_attention.launches == n + 1
    q16 = q.reshape(2, 8, 128, 16)
    pa.multi_head_attention(q16, q16, q16)
    assert fa.flash_attention.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (1, 1, 96, 128),
                                   (1, 1, 0, 128)])
def test_kernel_rejects_shapes_it_does_not_take(shape):
    _card()
    q = torch.zeros(shape, device="cuda")
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, q, q, sm_scale=1.0)
