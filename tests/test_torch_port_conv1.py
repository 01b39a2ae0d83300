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

from cvad_tpu_torch.ops.pallas_conv import (K1_COLS, K1_FRAMES,
                                            fold_input, fold_kernel,
                                            k1_rows, k1_units, tfold_conv1,
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
                                     (5, 4, 18, 14), (2, 3, 9, 7),
                                     (3, 5, 9, 7), (2, 1, 64, 64),
                                     (2, 64, 64, 64), (2, 9, 70, 130)])
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


# ---------------------------------------------------------------------------
# the kernels' launch plan and the bf16 kernel's K order (pure Python)
# ---------------------------------------------------------------------------

H100_SMS = 132
# the bf16 kernel's staged slab: (row, frame, channel) strides in bf16
# elements by output rows a unit, and the offset of column p = 0
# (csrc/tfold_conv1.cu's Slab<uint16_t, R>)
K1_SLAB_BF16 = {4: (80, 752, 7568), 1: (80, 240, 2448)}
SLAB_BASE = 6


def k1_bank_quarter(combo, rows):
    """The shared-memory bank quarter (32-bit words mod 32, by 8) at which
    the bf16 kernel's slab holds tap combo (c, kt, kh) = (combo // 9,
    combo // 3 % 3, combo % 3) relative to a position."""
    rs, fs, cs = K1_SLAB_BF16[rows]
    c, kt, kh = combo // 9, combo // 3 % 3, combo % 3
    return (c * cs + kt * fs + kh * rs) // 2 % 32 // 8


def k1_tap_table(rows=4):
    """The bf16 kernel's K order written out from the slab's bank quarters:
    4 rows (lane class t = lane % 4) of 15, the (c, kt, kh) combos of bank
    quarter t, first as the (kw = 1, 2) pairs (entries 0-6), then as kw = 0
    singles taken two at a time (entries 7-14); -1 marks a zero tap."""
    table = []
    for q in range(4):
        combos = [e for e in range(27) if k1_bank_quarter(e, rows) == q]
        table.append(tuple(combos + [-1] * (7 - len(combos))
                           + combos + [-1] * (8 - len(combos))))
    return tuple(table)


@pytest.mark.parametrize("b,t,rows", [(1, 8, 1), (8, 8, 1), (32, 8, 1),
                                      (128, 8, 4), (256, 8, 4),
                                      (128, 64, 4), (2, 64, 1)])
def test_k1_rows_by_shape(b, t, rows):
    """4 output rows a unit where that gives each SM two units (the bulk
    and train batches, the long window), 1 for the serving buckets, whose
    units then number B x 32 at T=8 (the parent's thread count)."""
    assert k1_rows(b, t, 64, 64, H100_SMS) == rows
    units = k1_units(b, t, 64, 64, rows)
    assert units == 32 // rows * -(-t // 8) * b
    if rows == 4:
        assert units >= 2 * H100_SMS


@pytest.mark.parametrize("h,w,rows", [(64, 64, 4), (9, 7, 1), (70, 130, 4),
                                      (1, 1, 1), (66, 64, 1)])
def test_k1_units_cover_every_output(h, w, rows):
    """Units of 32 columns x `rows` rows x 8 frames tile (T, Ho, Wo) with
    no output left out (the last band, row group and frame run ragged)."""
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    t = 11
    units = k1_units(1, t, h, w, rows)
    bands, runs = -(-wo // K1_COLS) * -(-ho // rows), -(-t // K1_FRAMES)
    assert units == bands * runs
    covered = np.zeros((t, ho, wo), bool)
    for u in range(units):  # as csrc/tfold_conv1.cu's unit_at numbers them
        band, run = u % bands, u // bands
        cb, rb = band % -(-wo // K1_COLS), band // -(-wo // K1_COLS)
        covered[run * K1_FRAMES:(run + 1) * K1_FRAMES,
                rb * rows:(rb + 1) * rows,
                cb * K1_COLS:(cb + 1) * K1_COLS] = True
    assert covered.all()


def test_tap_table_orders_every_tap_once():
    """Every (c, kt, kh) once among the pair entries (its kw = 1, 2 taps)
    and once among the single entries (its kw = 0 tap), so K holds each of
    the 81 taps once; zero taps only at entries 6, 13 and 14, the ones the
    kernel masks; row t holds bank quarter t's combos alone, in the
    kernel's closed form."""
    table = k1_tap_table()
    assert k1_tap_table(1) == table
    assert len(table) == 4 and all(len(r) == 15 for r in table)
    pairs = sorted(e for r in table for e in r[:7] if e >= 0)
    singles = sorted(e for r in table for e in r[7:] if e >= 0)
    assert pairs == singles == list(range(27))
    for q, row in enumerate(table):
        # csrc/tfold_conv1.cu's lane_setup: combos q, q + 4, ... below 27
        closed = [q + 4 * i if q + 4 * i < 27 else -1 for i in range(7)]
        assert list(row) == closed + closed + [-1]
        assert all(i in (6, 13, 14) for i, e in enumerate(row) if e < 0)
        for e in row:
            if e >= 0:
                c, kt, kh = e // 9, e // 3 % 3, e % 3
                assert q == (c + 3 * kt + kh) % 4


@pytest.mark.parametrize("rows", [4, 1])
def test_tap_table_loads_hit_distinct_banks(rows):
    """For every A load of the bf16 kernel (a group of the table, rows g or
    g + 8 of an m16 tile, any frame, row and half), the 32 lanes read 32
    distinct 4-byte banks, or one word between two lanes."""
    rs, fs, _ = K1_SLAB_BF16[rows]
    table = k1_tap_table(rows)
    base = SLAB_BASE

    def off(e):
        return e // 9 * K1_SLAB_BF16[rows][2] + e // 3 % 3 * fs + e % 3 * rs

    # (entry, p offset): pairs read a word at p = 2 ow' + 2, singles a
    # half at p = 2 ow' + 1
    loads = [(i, 2) for i in range(7)] + [(i, 1) for i in range(7, 15)]
    for f in range(8):
        for r in range(rows):
            for hh in range(2):
                for plus in (0, 16):
                    for i, p in loads:
                        words = {}
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            # a zero tap reads entry 0's combo (masked)
                            e = table[t][i] if table[t][i] >= 0 else \
                                table[t][0]
                            el = (base + f * fs + 2 * r * rs + 32 * hh
                                  + 2 * g + p + plus + off(e))
                            words.setdefault(el // 2 % 32, set()).add(el // 2)
                        assert all(len(v) == 1 for v in words.values()), \
                            (f, r, hh, plus, i)


def _emulate_bf16_kernel(x, w, rows):
    """The bf16 kernel's data flow in float64 for one clip: each unit's
    slab staged at the kernel's strides (p = 0 is column 2 ow0 - 2, zeros
    past the edges), each output gathered through the tap table's K order
    at p = 2 ow' + kw + 1 and multiplied by the weight of the same tap."""
    rs, fs, cs = K1_SLAB_BF16[rows]
    base = SLAB_BASE
    b, c_in, t, h, wd = x.shape
    assert b == 1
    ho, wo = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    taps = []  # (combo, kw) in K order, lane classes in turn
    for row in k1_tap_table(rows):
        taps += [(e, kw) for e in row[:7] if e >= 0 for kw in (1, 2)]
        taps += [(e, 0) for e in row[7:] if e >= 0]
    wk = np.stack([w[:, e // 9, e // 3 % 3, e % 3, kw] for e, kw in taps], 1)
    offs = np.array([e // 9 * cs + e // 3 % 3 * fs + e % 3 * rs + kw + 1
                     for e, kw in taps])
    y = np.zeros((b, 16, t, ho, wo))
    xp = np.zeros((b, c_in, t + 2, h + 2 * rows + 4, wd + 2 * K1_COLS + 4))
    xp[:, :, 1:t + 1, 1:h + 1, 2:wd + 2] = x  # index + 1 rows, + 2 cols
    for run in range(-(-t // K1_FRAMES)):
        t0 = run * K1_FRAMES
        for oh0 in range(0, ho, rows):
            for ow0 in range(0, wo, K1_COLS):
                slab = np.zeros(base + c_in * cs + 80)
                for c in range(c_in):
                    for fi in range(K1_FRAMES + 2):
                        ti = t0 - 1 + fi
                        if not 0 <= ti < t:
                            continue
                        for ri in range(2 * rows + 1):
                            hi = 2 * oh0 - 1 + ri
                            start = base + c * cs + fi * fs + ri * rs
                            # columns 2 ow0 - 2 .. 2 ow0 + 63
                            slab[start:start + 66] = xp[
                                0, c, ti + 1, hi + 1, 2 * ow0:2 * ow0 + 66]
                for f in range(K1_FRAMES):
                    if t0 + f >= t:
                        continue
                    for r in range(rows):
                        if oh0 + r >= ho:
                            continue
                        for owp in range(min(K1_COLS, wo - ow0)):
                            a = slab[base + f * fs + 2 * r * rs + 2 * owp
                                     + offs]
                            y[0, :, t0 + f, oh0 + r, ow0 + owp] = wk @ a
    return y


@pytest.mark.parametrize("t,h,w", [(3, 9, 7), (9, 20, 70), (1, 5, 3)])
@pytest.mark.parametrize("rows", [4, 1])
def test_bf16_kernel_emulation_matches_plain(t, h, w, rows):
    """The bf16 kernel's slab layout, halo and K order, emulated in
    float64, give the conv (F.conv3d in float64) within 1e-9: every tap is
    gathered from
    the staged column it reads (two column bands at W=70, two frame runs
    at T=9, a ragged last row group)."""
    rng = np.random.default_rng(t * 100 + h + w + rows)
    x = rng.normal(size=(1, 3, t, h, w))
    k = rng.normal(size=(16, 3, 3, 3, 3))
    ref = F.conv3d(torch.from_numpy(x), torch.from_numpy(k),
                   stride=(1, 2, 2), padding=1).numpy()  # float64
    np.testing.assert_allclose(_emulate_bf16_kernel(x, k, rows), ref,
                               rtol=0, atol=1e-9)
