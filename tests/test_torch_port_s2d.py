"""K4 and K5, the space-to-depth T-group-folded conv1 of long windows: the
port's fold transforms and plain versions against `cvad_tpu`'s
(`cvad_tpu/ops/pallas_s2d.py`) and its Pallas kernels in interpret mode,
and against ``lax.conv`` through ``jax.grad``, on the CPU; the CUDA kernels
against the plain versions on a card.

The small case is `tests/test_s2d_fold.py`'s: B=2, T=16, 16x16, C=3, O=16,
g=4 (K = 72, N = 64, slabs padded to 128).  Tolerances are that file's:
5e-6 forward, 1e-5 for the input gradient, atol 1e-3 / rtol 1e-5 for the
weight gradient (sums over every output pixel).  JAX and `cvad_tpu` are
imported inside the tests that use them, so that the card tests run on a
machine without JAX.
"""

import numpy as np
import pytest
import torch

from cvad_tpu_torch.ops import pallas_s2d as ps

B, T, H, W, C, O, G = 2, 16, 16, 16, 3, 16, 4


def _case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    k = (0.1 * rng.normal(size=(3, 3, 3, C, O))).astype(np.float32)
    return x, k


def _np(t):
    return t.detach().numpy()


def _ref_conv(x, k):
    import jax

    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    return jax.lax.conv_general_dilated(x, k, (1, 2, 2),
                                        ((1, 1), (1, 1), (1, 1)),
                                        dimension_numbers=dn)


def _perm(y, axes):
    return y.permute(*axes) if isinstance(y, torch.Tensor) else \
        y.transpose(axes)


def _unfold_groups(y):
    """K4's (B*n, H/2, W/2, g*O) -> (B, T, H/2, W/2, O), numpy, JAX or
    torch."""
    y = y.reshape(B, T // G, H // 2, W // 2, G, O)
    return _perm(y, (0, 1, 4, 2, 3, 5)).reshape(B, T, H // 2, W // 2, O)


def _unfold_tmajor(y):
    """K5's (B, H/2, W/2, T*O) -> (B, T, H/2, W/2, O)."""
    return _perm(y.reshape(B, H // 2, W // 2, T, O), (0, 3, 1, 2, 4))


# -- fold transforms -----------------------------------------------------------


@pytest.mark.parametrize("name", ["s2d_fold_input", "s2d_fold_kernel",
                                  "s2d_foldT_input", "s2d_fold_groups",
                                  "_pad_wd"])
def test_fold_transform_matches_jax_exactly(name):
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    x, k = _case()
    if name in ("s2d_fold_input", "s2d_fold_groups"):
        args = ((x, G), (torch.from_numpy(x), G))
    elif name == "s2d_foldT_input":
        args = ((x,), (torch.from_numpy(x),))
    elif name == "s2d_fold_kernel":
        args = ((k, G), (torch.from_numpy(k), G))
    else:
        wd = np.array(jps.s2d_fold_kernel(jnp.asarray(k), G))
        args = ((wd,), (torch.from_numpy(wd),))
    want = np.asarray(getattr(jps, name)(*args[0]))
    got = _np(getattr(ps, name)(*args[1]))
    np.testing.assert_array_equal(got, want)


# -- K4 ------------------------------------------------------------------------


def _k4_inputs():
    x, k = _case()
    xf = ps.s2d_fold_input(torch.from_numpy(x), G)
    wd = ps.s2d_fold_kernel(torch.from_numpy(k), G)
    return x, k, xf, wd


@pytest.mark.parametrize("core", ["s2d_fold_matmul", "_xla_dot_core",
                                  "_xla_core"])
def test_k4_forward_matches_pallas_and_lax_conv(core):
    """The port's plain K4 forward (the CPU route of `s2d_fold_matmul`) and
    its conv reference, against the Pallas kernel in interpret mode and
    against ``lax.conv`` of the unfolded conv."""
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    x, k, xf, wd = _k4_inputs()
    before = ps.s2d_fold_matmul.launches
    got = _np(getattr(ps, core)(xf, wd))
    assert ps.s2d_fold_matmul.launches == before  # the CPU launches nothing
    want = np.asarray(jps.s2d_fold_matmul(jnp.asarray(_np(xf)),
                                          jnp.asarray(_np(wd)),
                                          interpret=True))
    assert got.shape == want.shape == (B * T // G, H // 2, W // 2, G * O)
    np.testing.assert_allclose(got, want, atol=5e-6)
    np.testing.assert_allclose(_unfold_groups(got),
                               np.asarray(_ref_conv(x, k)), atol=5e-6)


def test_k4_grads_match_pallas_interpret_and_lax_conv():
    """The Function's gradient (the plain dgrad and wgrad on the CPU)
    against ``jax.grad`` through the Pallas kernels in interpret mode and
    through ``lax.conv``, w.r.t. the clip and the (3, 3, 3, C, O) kernel."""
    import jax
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    x, k = _case()
    ct = np.random.default_rng(5).normal(
        size=(B, T, H // 2, W // 2, O)).astype(np.float32)

    def loss_s2d(xj, kj):
        y = jps.s2d_fold_matmul(jps.s2d_fold_input(xj, G),
                                jps.s2d_fold_kernel(kj, G), interpret=True)
        return jnp.sum(_unfold_groups(y) * ct)

    def loss_ref(xj, kj):
        return jnp.sum(_ref_conv(xj, kj) * ct)

    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    y = ps.s2d_fold_matmul(ps.s2d_fold_input(xt, G),
                           ps.s2d_fold_kernel(kt, G))
    gx, gk = torch.autograd.grad(
        (_unfold_groups(y) * torch.from_numpy(ct)).sum(), (xt, kt))
    for fn in (loss_s2d, loss_ref):
        jgx, jgk = jax.grad(fn, (0, 1))(jnp.asarray(x), jnp.asarray(k))
        np.testing.assert_allclose(_np(gx), np.asarray(jgx), atol=1e-5)
        np.testing.assert_allclose(_np(gk), np.asarray(jgk), atol=1e-3,
                                   rtol=1e-5)


@pytest.mark.parametrize("part", ["dgrad", "wgrad"])
def test_k4_plain_backward_matches_pallas_kernel(part):
    """Each plain backward against the Pallas kernel it stands for, in
    interpret mode, on the same folded operands."""
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    _, _, xf, wd = _k4_inputs()
    ct = np.random.default_rng(6).normal(
        size=(B * T // G, H // 2, W // 2, G * O)).astype(np.float32)
    if part == "dgrad":
        want = jps._make_dgrad(True)(jnp.asarray(ct), jnp.asarray(_np(wd)),
                                     jnp.float32)
        got = ps.s2d_matmul_dgrad_reference(torch.from_numpy(ct), wd)
        tol = dict(atol=1e-5)
    else:
        want = jps._make_wgrad(True)(jnp.asarray(_np(xf)), jnp.asarray(ct),
                                     jnp.float32)
        got = ps.s2d_matmul_wgrad_reference(xf, torch.from_numpy(ct))
        tol = dict(atol=1e-3, rtol=1e-5)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


def _dense_k4(seed=9):
    """K4's operands with a dense random wd, 0.1 N(0, 1) in every entry (the
    scale of `_case`'s kernel, so the sums stay near the folded case's and
    the file's absolute tolerances hold for float32 sums in another order):
    the general contract of `s2d_fold_matmul` (any (2, 2, K, N) weights),
    where the folded wd of the cases above is block-banded."""
    rng = np.random.default_rng(seed)
    x, _ = _case()
    xf = _np(ps.s2d_fold_input(torch.from_numpy(x), G))
    wd = (0.1 * rng.normal(size=(2, 2, xf.shape[-1], G * O))).astype(
        np.float32)
    ct = rng.normal(size=xf.shape[:1] + (H // 2, W // 2, G * O)).astype(
        np.float32)
    return xf, wd, ct


@pytest.mark.parametrize("part", ["forward", "dgrad", "wgrad"])
def test_k4_plain_matches_pallas_on_dense_weights(part):
    """The port's plain K4 (the CPU route of `s2d_fold_matmul`, its
    backward through the Function) against `cvad_tpu`'s K4 in interpret
    mode on a dense random wd, at the file's K4 tolerances."""
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    xf, wd, ct = _dense_k4()
    if part == "forward":
        got = _np(ps.s2d_fold_matmul(torch.from_numpy(xf),
                                     torch.from_numpy(wd)))
        want = jps.s2d_fold_matmul(jnp.asarray(xf), jnp.asarray(wd),
                                   interpret=True)
        tol = dict(atol=5e-6)
    else:
        xt = torch.from_numpy(xf).requires_grad_(True)
        wt = torch.from_numpy(wd).requires_grad_(True)
        gx, gw = torch.autograd.grad(ps.s2d_fold_matmul(xt, wt), (xt, wt),
                                     torch.from_numpy(ct))
        if part == "dgrad":
            got = _np(gx)
            want = jps._make_dgrad(True)(jnp.asarray(ct), jnp.asarray(wd),
                                         jnp.float32)
            tol = dict(atol=1e-5)
        else:
            got = _np(gw)
            want = jps._make_wgrad(True)(jnp.asarray(xf), jnp.asarray(ct),
                                         jnp.float32).reshape(wd.shape)
            tol = dict(atol=1e-3, rtol=1e-5)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (np.abs(want) > 1e-3).mean() > 0.99  # dense: no banded zeros
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("k,n,wc,dtype,route", [
    (120, 128, 33, torch.bfloat16, "tensor_cores"),  # g=8, C=3, O=16, 64x64
    (120, 128, 33, torch.float32, "cuda_cores"),     # f32: never TF32
    (40, 128, 33, torch.bfloat16, "tensor_cores"),   # grayscale, g=8
    (72, 128, 9, torch.bfloat16, "tensor_cores"),    # O=32, g=4
    (72, 64, 9, torch.bfloat16, "tensor_cores"),     # the small case
    (72, 20, 9, torch.bfloat16, "cuda_cores"),       # N % 8 != 0
    (36, 64, 9, torch.bfloat16, "cuda_cores"),       # K % 8 != 0
    (136, 64, 9, torch.bfloat16, "cuda_cores"),      # K > 128
    (72, 136, 9, torch.bfloat16, "cuda_cores"),      # N > 128
    (128, 128, 38, torch.bfloat16, "tensor_cores"),  # the widest, at the
    (128, 128, 39, torch.bfloat16, "cuda_cores"),    # Wc cap and past it
    (120, 128, 65, torch.bfloat16, "cuda_cores"),    # 128x128 frames
])
def test_k4_route_by_shape(k, n, wc, dtype, route):
    """`k4_route` chooses from the shapes alone, before any launch: the
    tensor cores for bf16 with K, N multiples of 8 up to 128 at Wc up to
    K4_TC_MAX_WC (where the shared memory fits), the CUDA cores otherwise
    and for every float32 call."""
    assert ps.k4_route(k, n, wc, dtype) == route


@pytest.mark.parametrize("g,cin,cout,route", [
    (8, 3, 16, "tensor_cores"), (4, 3, 32, "tensor_cores"),
    (8, 1, 16, "tensor_cores"), (2, 3, 64, "tensor_cores"),
    (1, 2, 128, "tensor_cores"),
    (1, 3, 128, "cuda_cores")])  # K = 36: g and C odd
def test_k4_route_for_model_widths(g, cin, cout, route):
    """The folds a model builds (g*O <= 128, the fold's rule) with O % 8 ==
    0 take the tensor cores in bfloat16 at 64x64 clips wherever K =
    (g+2)*4C is a multiple of 8, that is where g or C is even."""
    k, n = (g + 2) * 4 * cin, g * cout
    assert ps.k4_route(k, n, 33, torch.bfloat16) == route


# -- K5 ------------------------------------------------------------------------


@pytest.mark.parametrize("core", ["s2d_group_conv", "_xla_groups_core"])
def test_k5_forward_matches_pallas_and_lax_conv(core):
    """The whole-T grouped conv: the port's plain K5 (the CPU route of
    `s2d_group_conv`) and the per-group reference on the whole-T fold,
    against the Pallas kernel in interpret mode and ``lax.conv``."""
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    x, k = _case()
    xt = torch.from_numpy(x)
    wd = ps.s2d_fold_kernel(torch.from_numpy(k), G)
    before = ps.s2d_group_conv.launches
    if core == "s2d_group_conv":
        got = _np(ps.s2d_group_conv(ps.s2d_fold_groups(xt, G), wd, G))
    else:
        got = _np(ps._xla_groups_core(ps.s2d_foldT_input(xt), wd, G))
    assert ps.s2d_group_conv.launches == before
    want = np.asarray(jps.s2d_group_conv(jps.s2d_fold_groups(x, G),
                                         jps.s2d_fold_kernel(k, G), G,
                                         interpret=True))
    assert got.shape == want.shape == (B, H // 2, W // 2, T * O)
    np.testing.assert_allclose(got, want, atol=5e-6)
    np.testing.assert_allclose(_unfold_tmajor(got),
                               np.asarray(_ref_conv(x, k)), atol=5e-6)


def test_k5_grads_match_pallas_interpret_and_lax_conv():
    """K5's gradient in the port (plain wgrad, dgrad through the plain
    version) against ``jax.grad`` through `s2d_group_conv(...,
    interpret=True)` and through ``lax.conv``."""
    import jax
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    x, k = _case()
    ct = np.random.default_rng(7).normal(
        size=(B, T, H // 2, W // 2, O)).astype(np.float32)

    def loss_s2d(xj, kj):
        y = jps.s2d_group_conv(jps.s2d_fold_groups(xj, G),
                               jps.s2d_fold_kernel(kj, G), G, interpret=True)
        return jnp.sum(_unfold_tmajor(y) * ct)

    def loss_ref(xj, kj):
        return jnp.sum(_ref_conv(xj, kj) * ct)

    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    y = ps.s2d_group_conv(ps.s2d_fold_groups(xt, G),
                          ps.s2d_fold_kernel(kt, G), G)
    gx, gk = torch.autograd.grad(
        (_unfold_tmajor(y) * torch.from_numpy(ct)).sum(), (xt, kt))
    for fn in (loss_s2d, loss_ref):
        jgx, jgk = jax.grad(fn, (0, 1))(jnp.asarray(x), jnp.asarray(k))
        np.testing.assert_allclose(_np(gx), np.asarray(jgx), atol=1e-5)
        np.testing.assert_allclose(_np(gk), np.asarray(jgk), atol=1e-3,
                                   rtol=1e-5)


def test_k5_plain_wgrad_matches_pallas_kernel():
    import jax.numpy as jnp

    from cvad_tpu.ops import pallas_s2d as jps

    x, k = _case()
    xg = ps.s2d_fold_groups(torch.from_numpy(x), G)
    kp = ps._pad_wd(ps.s2d_fold_kernel(torch.from_numpy(k), G)).shape[1]
    ct = np.random.default_rng(8).normal(
        size=(B, H // 2, W // 2, T * O)).astype(np.float32)
    want = jps._make_group_wgrad(True)(jnp.asarray(_np(xg)), jnp.asarray(ct),
                                       kp, jnp.float32)
    got = ps.s2d_group_wgrad_reference(xg, torch.from_numpy(ct), kp)
    assert got.shape == want.shape == (4, 128, G * O)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-3,
                               rtol=1e-5)


def test_k5_plain_bf16_accumulates_in_f32():
    """bf16 in, bf16 out; the sum is the f32 one rounded once (half a bf16
    ulp, 2^-8 relative, beyond f32 order differences)."""
    x, k = _case()
    xg = ps.s2d_fold_groups(torch.from_numpy(x), G)
    wd = ps.s2d_fold_kernel(torch.from_numpy(k), G)
    got = ps.s2d_group_conv(xg.bfloat16(), wd.bfloat16(), G)
    assert got.dtype == torch.bfloat16
    ref = ps.s2d_group_conv(xg.bfloat16().float(), wd.bfloat16().float(), G)
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("cin,cout,g", [(3, 16, 8), (1, 16, 8), (3, 32, 4)])
def test_band_mask_is_the_fold_kernels_nonzero_pattern(cin, cout, g):
    """`s2d_band_mask` is exactly where `s2d_fold_kernel` (padded) of a
    kernel with no zero entry is nonzero in some tap: the entries K5's
    kernels compute."""
    k = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1.5, (3, 3, 3, cin, cout)).astype(np.float32))
    wdp = ps._pad_wd(ps.s2d_fold_kernel(k, g))
    mask = ps.s2d_band_mask(g, cin, cout, wdp.shape[1])
    assert mask.shape == wdp.shape[1:] and mask.dtype == torch.bool
    assert torch.equal(mask, (wdp != 0).any(0))
    assert int(mask.sum()) == g * 12 * cin * cout


def test_k5_rejects_mismatched_slabs():
    x, k = _case()
    xg = ps.s2d_fold_groups(torch.from_numpy(x), G)
    wd = ps.s2d_fold_kernel(torch.from_numpy(k), G)
    with pytest.raises(ValueError):
        ps.s2d_group_conv(xg[..., :-8], wd, G)


# -- the kernels on a card -----------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=False, deterministic=True,
                   allow_tf32=False)


CARD_CASES = [(2, 16, 16, 16, 4), (3, 64, 64, 64, 8), (1, 16, 10, 14, 8)]
# K4 on dense random weights, (rows, Hc, Wc, K, N, the route in bf16): one
# shape a route (N % 8 != 0 takes the CUDA cores), the main shape's width,
# and the widest K and N at Wc = K4_TC_MAX_WC and one past it
K4_DENSE = [(8, 9, 9, 72, 64, "tensor_cores"), (8, 9, 9, 72, 20, "cuda_cores"),
            (6, 33, 33, 120, 128, "tensor_cores"),
            (2, 9, ps.K4_TC_MAX_WC, 128, 128, "tensor_cores"),
            (2, 9, ps.K4_TC_MAX_WC + 1, 128, 128, "cuda_cores")]


def _card_inputs(b, t, h, w, g, dtype, seed=0, cin=C, cout=O):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (b, t, h, w, cin))
                         .astype(np.float32)).cuda().to(dtype)
    k = torch.from_numpy(rng.normal(0, 0.2, (3, 3, 3, cin, cout))
                         .astype(np.float32)).cuda().to(dtype)
    return x, k


def _close(got, ref, dtype, what):
    """float32: atol 1e-4 (f32 sums of up to 4*128 terms in another order);
    bf16 outputs: one bf16 rounding of the f32 sum, 2^-8 relative."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4, msg=what)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2,
                                   atol=1e-4, msg=what)


def _wgrad_close(got, ref, what):
    """Weight gradients (float32 sums over every pixel, in another order):
    within 1e-5 of the largest |ref| entry."""
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * scale, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES + K4_DENSE)
def test_k4_kernels_match_plain_on_card(dtype, case):
    """Forward, input and weight gradient against the plain versions, on
    the folded kernel of CARD_CASES and on dense N(0, 1) weights at
    K4_DENSE (the weight gradient compared in full), on the route
    `k4_route` gives; a second call bit-identical."""
    flags = _card()
    gen = torch.Generator("cuda").manual_seed(1)
    if case in CARD_CASES:
        b, t, h, w, g = case
        bf16_route = "tensor_cores"
        x, k = _card_inputs(b, t, h, w, g, dtype)
        xf = ps.s2d_fold_input(x, g).contiguous()
        wd = ps.s2d_fold_kernel(k, g).contiguous()
    else:
        rows, hc, wc, kc, n, bf16_route = case
        xf = torch.rand((rows, hc, wc, kc), generator=gen,
                        device="cuda").to(dtype)
        wd = torch.randn((2, 2, kc, n), generator=gen,
                         device="cuda").to(dtype)
    w4 = wd.reshape(4, wd.shape[2], wd.shape[3])
    ct = torch.randn((xf.shape[0], xf.shape[1] - 1, xf.shape[2] - 1,
                      wd.shape[3]), generator=gen, device="cuda").to(dtype)
    route = ps.k4_route(wd.shape[2], wd.shape[3], xf.shape[2], dtype)
    assert route == (bf16_route if dtype == torch.bfloat16
                     else "cuda_cores")
    with flags:
        y = ps._launch_forward(xf, w4)
        dx = ps._launch_dgrad(ct, w4)
        dw = ps._launch_wgrad(xf, ct)
        again = (ps._launch_forward(xf, w4), ps._launch_dgrad(ct, w4),
                 ps._launch_wgrad(xf, ct))
        xf32, wd32, ct32 = xf.float(), wd.float(), ct.float()
        ref_y = ps._xla_dot_core(xf32, wd32)
        ref_dx = ps.s2d_matmul_dgrad_reference(ct32, wd32)
        ref_dw = ps.s2d_matmul_wgrad_reference(xf32, ct32)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    _close(y, ref_y, dtype, "K4 forward")
    _close(dx, ref_dx, dtype, "K4 dgrad")
    _wgrad_close(dw.reshape(ref_dw.shape), ref_dw, "K4 wgrad")
    for a, b2 in zip((y, dx, dw), again):
        assert torch.equal(a, b2)  # no atomics: bit-identical


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(C, O), (1, 16), (3, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,w,g", CARD_CASES)
def test_k5_kernels_match_plain_on_card(dtype, b, t, h, w, g, cin, cout):
    """The band kernels against the plain versions (RGB, grayscale, and 32
    output channels): the forward at `_close`'s tolerances; the weight
    gradient's band entries (`s2d_band_mask`) at `_wgrad_close`'s, its
    other entries exact zeros; a second call bit-identical."""
    flags = _card()
    x, k = _card_inputs(b, t, h, w, g, dtype, cin=cin, cout=cout)
    xg = ps.s2d_fold_groups(x, g).contiguous()
    wdp = ps._pad_wd(ps.s2d_fold_kernel(k, g)).contiguous()
    kp, n = wdp.shape[1], xg.shape[-1] // wdp.shape[1]
    ct = torch.randn((b, xg.shape[1] - 1, xg.shape[2] - 1, t * cout),
                     generator=torch.Generator("cuda").manual_seed(2),
                     device="cuda").to(dtype)
    with flags:
        y = ps._launch_group_forward(xg, wdp, g, cin, cout)
        dw = ps._launch_group_wgrad(xg, ct, g, cin, cout, kp)
        again = (ps._launch_group_forward(xg, wdp, g, cin, cout),
                 ps._launch_group_wgrad(xg, ct, g, cin, cout, kp))
        ref_y = ps._xla_slabs_core(xg.float(), wdp.float(), n)
        ref_dw = ps.s2d_group_wgrad_reference(xg.float(), ct.float(), kp)
    torch.cuda.synchronize()
    band = ps.s2d_band_mask(g, cin, cout, kp).cuda().expand_as(dw)
    _close(y, ref_y, dtype, "K5 forward")
    _wgrad_close(dw[band], ref_dw[band], "K5 wgrad, band")
    assert not dw[~band].any(), "K5 wgrad off the band"
    assert torch.equal(y, again[0]) and torch.equal(dw, again[1])


@pytest.mark.cuda
def test_functions_launch_and_count_on_card():
    """Through autograd: K4's forward, dgrad and wgrad each launch once; K5's
    forward and wgrad once, its dgrad (plain) not at all unless the input
    asks for a gradient."""
    flags = _card()
    x, k = _card_inputs(2, 16, 16, 16, 4, torch.float32)
    counts = (ps.s2d_fold_matmul.launches, ps.s2d_fold_matmul.dgrad_launches,
              ps.s2d_fold_matmul.wgrad_launches, ps.s2d_group_conv.launches,
              ps.s2d_group_conv.backward_launches)
    with flags:
        xr = x.clone().requires_grad_(True)
        kr = k.clone().requires_grad_(True)
        y4 = ps.s2d_fold_matmul(ps.s2d_fold_input(xr, 4),
                                ps.s2d_fold_kernel(kr, 4))
        torch.autograd.grad(y4.square().sum(), (xr, kr))
        kr2 = k.clone().requires_grad_(True)
        y5 = ps.s2d_group_conv(ps.s2d_fold_groups(x, 4),
                               ps.s2d_fold_kernel(kr2, 4), 4)
        (gk,) = torch.autograd.grad(y5.square().sum(), (kr2,))
    torch.cuda.synchronize()
    now = (ps.s2d_fold_matmul.launches, ps.s2d_fold_matmul.dgrad_launches,
           ps.s2d_fold_matmul.wgrad_launches, ps.s2d_group_conv.launches,
           ps.s2d_group_conv.backward_launches)
    assert [a - b for a, b in zip(now, counts)] == [1, 1, 1, 1, 1]
    assert torch.isfinite(gk).all()


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    _card()
    x, k = _card_inputs(1, 16, 16, 16, 8, torch.float32)
    xg = ps.s2d_fold_groups(x, 8).contiguous()
    wdp = ps._pad_wd(ps.s2d_fold_kernel(k, 8)).contiguous()
    # K4's kernels
    xf = ps.s2d_fold_input(x, 8).contiguous()
    w4 = ps.s2d_fold_kernel(k, 8).contiguous().reshape(4, xf.shape[-1], -1)
    with pytest.raises(TypeError):
        ps._launch_forward(xf.half(), w4.half())
    with pytest.raises(TypeError):
        ps._launch_forward(xf, w4.bfloat16())
    with pytest.raises(ValueError):
        ps._launch_forward(xf[..., :-8].contiguous(), w4)
    with pytest.raises(ValueError):
        ps._launch_forward(xf.transpose(1, 2), w4)
    with pytest.raises(ValueError):
        ps._launch_wgrad(xf, xf[:, 1:].contiguous())  # ct must be one
                                                      # row and column less
    # K5's band kernels
    with pytest.raises(TypeError):
        ps._launch_group_forward(xg.half(), wdp.half(), 8, C, O)
    with pytest.raises(ValueError):
        ps._launch_group_forward(xg[..., :-8].contiguous(), wdp, 8, C, O)
    with pytest.raises(ValueError):
        ps._launch_group_forward(xg, wdp, 4, C, O)
