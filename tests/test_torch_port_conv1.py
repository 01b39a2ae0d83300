"""K1, the T-folded conv1: the port's fold and plain version against
`cvad_tpu`'s Pallas kernel (interpret mode) and against F.conv3d, forward
and gradient; the CUDA kernel against the plain version on a card, forward
and gradient.

JAX and `cvad_tpu` are imported inside the tests that use them, so that the
card test runs on a machine without JAX (``--noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvad_tpu_torch.ops.pallas_conv import (fold_input, fold_kernel,
                                            tfold_conv1,
                                            tfold_conv1_reference)

SHAPES = [(2, 8, 16, 16), (1, 4, 8, 8)]   # (B, T, H, W), C=3, O=16


def _inputs(b, t, h, w, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, w, 3)).astype(np.float32)  # JAX layout
    k = rng.normal(size=(3, 3, 3, 3, 16)).astype(np.float32)  # (kT,kH,kW,I,O)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    wt = torch.from_numpy(k).permute(4, 3, 0, 1, 2).contiguous()
    return x, k, xt, wt


@pytest.mark.parametrize("b,t,h,w", SHAPES)
def test_fold_matches_jax(b, t, h, w):
    from cvad_tpu.ops import pallas_conv as jpc

    x, k, xt, wt = _inputs(b, t, h, w)
    np.testing.assert_array_equal(
        fold_input(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jpc.fold_input(x)))
    np.testing.assert_array_equal(
        fold_kernel(wt, t).permute(2, 3, 1, 0).numpy(),
        np.asarray(jpc.fold_kernel(k, t)))


@pytest.mark.parametrize("b,t,h,w", SHAPES)
def test_plain_matches_pallas_interpret(b, t, h, w):
    """CPU `tfold_conv1` == JAX `tfold_conv1_matmul(..., interpret=True)`,
    run as tests/test_pallas.py runs it."""
    import jax
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_conv as jpc

    x, k, xt, wt = _inputs(b, t, h, w)
    with jax.default_matmul_precision("highest"):
        ref = jpc.tfold_conv1_matmul(jpc.fold_input(jnp.asarray(x)),
                                     jpc.fold_kernel(jnp.asarray(k), t),
                                     interpret=True)
    # (B, Ho, Wo, T*O) t-major -> (B, O, T, Ho, Wo)
    ref = np.asarray(ref).reshape(b, h // 2, w // 2, t, 16)
    ref = ref.transpose(0, 4, 3, 1, 2)
    got = tfold_conv1(xt, wt)
    assert got.shape == (b, 16, t, h // 2, w // 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t,h,w", SHAPES + [(3, 5, 9, 7)])
def test_plain_matches_conv3d(b, t, h, w):
    """Odd sizes included: Ho = (H-1)//2 + 1, as Conv3d with padding 1."""
    _, _, xt, wt = _inputs(b, t, h, w)
    ref = F.conv3d(xt, wt, stride=(1, 2, 2), padding=1)
    got = tfold_conv1(xt, wt)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_plain_bf16_accumulates_in_f32():
    """bf16 in, bf16 out; the sum is the f32 one rounded once (half a bf16
    ulp, 2^-8 relative, beyond f32 order differences)."""
    _, _, xt, wt = _inputs(2, 4, 8, 8)
    xb, wb = xt.bfloat16(), wt.bfloat16()
    got = tfold_conv1(xb, wb)
    assert got.dtype == torch.bfloat16
    ref = F.conv3d(xb.float(), wb.float(), stride=(1, 2, 2), padding=1)
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -8, atol=1e-5)


def test_cpu_path_launches_nothing():
    _, _, xt, wt = _inputs(1, 4, 8, 8)
    before = tfold_conv1.launches
    tfold_conv1(xt, wt)
    assert tfold_conv1.launches == before


def _port_grads(xt, wt, g):
    x = xt.clone().requires_grad_(True)
    wgt = wt.clone().requires_grad_(True)
    gx, gw = torch.autograd.grad(tfold_conv1(x, wgt), (x, wgt), g)
    return gx, gw


@pytest.mark.parametrize("b,t,h,w", SHAPES)
def test_grad_matches_pallas_interpret(b, t, h, w):
    """The Function's gradient (x and weight) against `jax.grad` through
    `tfold_conv1_matmul(..., interpret=True)` (whose backward is `jax.vjp`
    of the folded reference conv).  atol 1e-4: sums of up to B*T*Ho*Wo
    products of N(0,1) values (the weight gradient) in another order."""
    import jax
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_conv as jpc

    x, k, xt, wt = _inputs(b, t, h, w)
    ct = np.random.default_rng(2).normal(
        size=(b, 16, t, h // 2, w // 2)).astype(np.float32)

    def loss(xj, kj):
        y = jpc.tfold_conv1_matmul(jpc.fold_input(xj), jpc.fold_kernel(kj, t),
                                   interpret=True)
        y = y.reshape(b, h // 2, w // 2, t, 16).transpose(0, 4, 3, 1, 2)
        return jnp.sum(y * ct)

    with jax.default_matmul_precision("highest"):
        jgx, jgk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(k))
    gx, gw = _port_grads(xt, wt, torch.from_numpy(ct))
    # JAX layouts -> torch's: x (B,T,H,W,C), kernel (kT,kH,kW,I,O)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(jgx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gw.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(jgk), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,t,h,w", SHAPES + [(3, 5, 9, 7)])
def test_grad_matches_conv3d_autograd(b, t, h, w):
    _, _, xt, wt = _inputs(b, t, h, w)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, 16, t, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    ).astype(np.float32))
    x = xt.clone().requires_grad_(True)
    wgt = wt.clone().requires_grad_(True)
    ref = torch.autograd.grad(F.conv3d(x, wgt, stride=(1, 2, 2), padding=1),
                              (x, wgt), g)
    got = _port_grads(xt, wt, g)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_on_card_matches_plain(dtype):
    """On the card the forward launches K1 and the gradient (x and weight)
    equals autograd through `tfold_conv1_reference`, within a share of the
    largest |ref| entry: 1e-5 in float32 (TF32 off; the weight gradient
    sums 32,768 products of N(0,1) values, in another order by each cuDNN
    algorithm), 2e-2 in bf16 (one bf16 rounding of f32 sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, xt, wt = _inputs(4, 8, 64, 64)
    x, wgt = xt.cuda().to(dtype), wt.cuda().to(dtype)
    g = torch.randn((4, 16, 8, 32, 32), generator=torch.Generator(
        "cuda").manual_seed(0), device="cuda").to(dtype)
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=False, deterministic=True,
                 allow_tf32=False):
        before = tfold_conv1.launches
        got = _port_grads(x, wgt, g)
        assert tfold_conv1.launches == before + 1
        xr = x.clone().requires_grad_(True)
        wr = wgt.clone().requires_grad_(True)
        ref = torch.autograd.grad(tfold_conv1_reference(xr, wr), (xr, wr), g)
    torch.cuda.synchronize()
    share = 1e-5 if dtype == torch.float32 else 2e-2
    for a, r in zip(got, ref):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), r.float(), rtol=0,
                                   atol=share * r.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,w", [(1, 8, 64, 64), (3, 8, 64, 64),
                                     (5, 4, 18, 14), (2, 3, 9, 7)])
def test_kernel_matches_plain_on_card(dtype, b, t, h, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, xt, wt = _inputs(b, t, h, w)
    x, wgt = xt.cuda().to(dtype), wt.cuda().to(dtype)
    before = tfold_conv1.launches
    got = tfold_conv1(x, wgt)
    torch.cuda.synchronize()
    assert tfold_conv1.launches == before + 1
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark,
                 deterministic=c.deterministic, allow_tf32=False):
        ref = tfold_conv1_reference(x.float(), wgt.float())
    assert got.dtype == dtype and got.shape == ref.shape
    if dtype == torch.float32:
        # inputs ~N(0,1): sums of 81 terms of size ~1, f32 order differences
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    else:
        # one bf16 rounding of the f32 sum: half an ulp, 2^-8 relative
        torch.testing.assert_close(got.float(), ref, rtol=1e-2, atol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, xt, wt = _inputs(1, 4, 8, 8)
    x, w = xt.cuda(), wt.cuda()
    with pytest.raises(TypeError):
        tfold_conv1(x.half(), w.half())
    with pytest.raises(ValueError):
        tfold_conv1(x.transpose(3, 4), w)
    with pytest.raises(ValueError):
        tfold_conv1(x[:, :2].contiguous(), w[:, :2].contiguous())
