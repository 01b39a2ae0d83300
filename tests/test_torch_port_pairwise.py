"""K2, the masked mean pairwise L1: the port's CPU path (the plain forward
and the closed-form backward) against `cvad_tpu`'s Pallas kernel in
interpret mode, value and `jax.grad`; the closed form against autograd of
the plain version; the CUDA kernels against the plain versions on a card.

JAX and `cvad_tpu` are imported inside the tests that use them, so that the
card tests run on a machine without flax.
"""

import numpy as np
import pytest
import torch

from cvad_tpu_torch.ops import pallas_kernels as pk
from cvad_tpu_torch.ops.pallas_kernels import (pairwise_backward_plan,
                                               pairwise_l1_backward_reference,
                                               pairwise_l1_mean,
                                               pairwise_l1_reference)

MASKS = ("zero", "single", "random", "one")
# the backward plan's edges: row tiles of 8, 16, 32 and 64 rows, ragged ones,
# one split (S = 1) and many, narrow and wide N
PLAN_B = (1, 2, 16, 17, 33, 128, 256, 257)
PLAN_N = (1, 7, 256, 9000)
PLAN_SMS = (1, 132, 200)


def _inputs(b, n, mask, seed=0, ties=True):
    rng = np.random.default_rng(seed)
    flat = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if ties:  # as on the adjacency's zero diagonal
        flat[:, :: max(n // 3, 1)] = 0.0
    m = {"zero": np.zeros(b), "one": np.ones(b),
         "single": np.eye(1, b, b // 2)[0],
         "random": (rng.uniform(size=b) > 0.4)}[mask].astype(np.float32)
    return flat, m


def _port(flat, m):
    f = torch.from_numpy(flat).requires_grad_(True)
    avg, n_pairs = pairwise_l1_mean(f, torch.from_numpy(m))
    (g,) = torch.autograd.grad(avg, f)
    return float(avg.detach()), float(n_pairs), g.numpy()


@pytest.mark.parametrize("b,n,mask", [(6, 256, "random"), (12, 36, "random"),
                                      (9, 300, "one"), (5, 7, "single")])
def test_matches_pallas_interpret(b, n, mask):
    """Value and gradient against `pairwise_l1_mean(..., interpret=True)`,
    run as tests/test_pallas.py runs it, on inputs without ties (see
    `test_ties_differ_from_jax_only_where_tied`).  rtol 1e-5 on the value:
    sums of a few hundred f32 terms in another order; atol 1e-6 on the
    gradient, whose entries are integer sums of signs times
    c / (n_pairs N)."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from cvad_tpu.ops.pallas_kernels import pairwise_l1_mean as jax_pairwise

    flat, m = _inputs(b, n, mask, ties=False)

    def avg_of(f):
        return jax_pairwise(f, jnp.asarray(m), interpret=True)[0]

    ref_avg, ref_n = jax_pairwise(jnp.asarray(flat), jnp.asarray(m),
                                  interpret=True)
    ref_g = np.asarray(jax.grad(avg_of)(jnp.asarray(flat)))
    avg, n_pairs, g = _port(flat, m)
    assert n_pairs == float(ref_n)
    np.testing.assert_allclose(avg, float(ref_avg), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g, ref_g, rtol=0, atol=1e-6)


def test_ties_differ_from_jax_only_where_tied():
    """JAX differentiates |x| at 0 as +1 (``jax.grad(jnp.abs)(0.0) == 1``),
    torch and the port as 0.  So at exact ties f_ik == f_jk the gradient of
    `cvad_tpu`'s pairwise L1 takes +1 for the earlier row of the pair and -1
    for the later one, and the port takes 0: the two differ in the tied
    columns and nowhere else.  On the family-D path the only ties are on
    the adjacency's zero diagonal, whose gradient the (1 - eye) mask
    zeroes, so the parameters' gradients agree
    (tests/test_torch_port_train_step.py)."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from cvad_tpu.ops.pallas_kernels import pairwise_l1_mean as jax_pairwise

    flat, m = _inputs(8, 30, "one")
    tied = np.zeros(30, bool)
    tied[::10] = True
    ref_g = np.asarray(jax.grad(lambda f: jax_pairwise(
        f, jnp.asarray(m), interpret=True)[0])(jnp.asarray(flat)))
    _, _, g = _port(flat, m)
    np.testing.assert_allclose(g[:, ~tied], ref_g[:, ~tied], rtol=0,
                               atol=1e-6)
    assert not g[:, tied].any()
    # earlier rows of tied pairs +1 each, later ones -1 each: row i has
    # (B-1-i) - i of them, times 1 / (n_pairs N)
    b = len(m)
    expect = (b - 1 - 2 * np.arange(b)) / (b * (b - 1) / 2 * 30)
    np.testing.assert_allclose(ref_g[:, tied],
                               np.repeat(expect[:, None], tied.sum(), 1),
                               rtol=1e-6)


@pytest.mark.parametrize("mask", MASKS)
def test_closed_form_backward_matches_autograd(mask):
    """The closed form the backward kernel computes equals autograd of the
    plain (B, B, N) version, ties included (sign(0) = 0 in both)."""
    flat, m = _inputs(11, 40, mask, seed=3)
    f = torch.from_numpy(flat).requires_grad_(True)
    mt = torch.from_numpy(m)
    avg, n_pairs = pairwise_l1_reference(f, mt)
    ct = torch.tensor(0.37)
    (auto,) = torch.autograd.grad(avg, f, ct)
    closed = pairwise_l1_backward_reference(f.detach(), mt, n_pairs, ct)
    torch.testing.assert_close(closed, auto, rtol=0, atol=1e-7)


def test_no_pairs_and_one_row():
    """As tests/test_pallas.py: no masked row, or one, gives avg 0 and no
    pair, and a zero gradient."""
    for m in (np.zeros(4, np.float32), np.array([1, 0, 0, 0], np.float32)):
        avg, n_pairs, g = _port(np.ones((4, 16), np.float32), m)
        assert avg == 0.0 and n_pairs == 0.0
        assert not g.any()
    avg, n_pairs, g = _port(np.random.default_rng(1).uniform(
        size=(1, 9)).astype(np.float32), np.ones(1, np.float32))
    assert avg == 0.0 and n_pairs == 0.0 and not g.any()


def test_cpu_path_launches_nothing():
    before = (pairwise_l1_mean.launches, pairwise_l1_mean.backward_launches)
    _port(*_inputs(4, 8, "one"))
    assert (pairwise_l1_mean.launches,
            pairwise_l1_mean.backward_launches) == before


def _covered_once(n: int, size: int, count: int) -> bool:
    """`count` consecutive ranges of `size` (the last clipped at n) cover
    [0, n) exactly once, none of them empty."""
    seen = np.zeros(n, int)
    for c in range(count):
        if c * size >= n:
            return False
        seen[c * size:min(n, (c + 1) * size)] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("n", PLAN_N)
@pytest.mark.parametrize("b", PLAN_B)
def test_backward_plan_partitions_every_triple_once(b, n):
    """K2's backward plan at every SM count: the column chunks cover [0, N),
    the row tiles [0, B) and the splits of rows j [0, B), each exactly once
    and none empty, so every (i, k, j) is summed by one block; inside a
    row tile, thread t's column t % cols and rows (t // cols) * 8 + r
    (csrc/pairwise_l1.cu) cover the tile once; a staged tile fits its
    buffer; at most PAIR_BWD_MAX_SPLITS splits (one cluster), and the
    grid holds PAIR_BWD_BLOCKS_PER_SM blocks a SM unless the splits are at
    their most or their narrowest."""
    for sms in PLAN_SMS:
        plan = pairwise_backward_plan(b, n, sms)
        cx, ty, sz = plan.grid
        assert plan.cols in pk.PAIR_BWD_COLS
        assert plan.rows == pk.PAIR_BWD_THREADS // plan.cols * pk.PAIR_BWD_ROWS
        assert _covered_once(n, plan.cols, cx)
        assert _covered_once(b, plan.rows, ty)
        assert sz == plan.splits and _covered_once(b, plan.span, sz)
        assert plan.span % pk.PAIR_BWD_SPAN_ALIGN == 0
        assert 1 <= plan.stage_rows <= plan.span
        assert plan.stage_rows * plan.cols <= pk.PAIR_BWD_STAGE
        t = np.arange(pk.PAIR_BWD_THREADS)[:, None]
        r = np.arange(pk.PAIR_BWD_ROWS)[None, :]
        cells = ((t // plan.cols * pk.PAIR_BWD_ROWS + r) * plan.cols
                 + t % plan.cols).ravel()
        assert sorted(cells) == list(range(plan.rows * plan.cols))
        assert sz <= pk.PAIR_BWD_MAX_SPLITS
        narrower = plan.span - pk.PAIR_BWD_SPAN_ALIGN
        assert (cx * ty * sz >= pk.PAIR_BWD_BLOCKS_PER_SM * sms
                or sz == pk.PAIR_BWD_MAX_SPLITS or narrower == 0
                or -(-b // narrower) > pk.PAIR_BWD_MAX_SPLITS)


def _emulate_backward(flat, mask, n_pairs, ct, plan):
    """The backward kernels' arithmetic under `plan`: each split's sum of
    m_j sign(f_ik - f_jk) over its rows j, the S partials added in split
    order, then c m_i / (n_pairs N) as the kernels round it (0 without a
    pair or out of the mask)."""
    b, n = flat.shape
    parts = [(mask[None, j0:j0 + plan.span, None] * torch.sign(
        flat[:, None, :] - flat[None, j0:j0 + plan.span, :])).sum(1)
        for j0 in range(0, b, plan.span)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    scale = torch.where((n_pairs > 0) & (mask != 0),
                        ct * mask / (n_pairs * n), torch.zeros_like(mask))
    return acc * scale[:, None]


def _emulated_shapes():
    # N = 9000 at B <= 33: the plain version's (B, B, N) broadcast at
    # B = 128-257 would take gigabytes here; the card checks (33, 9000)
    # and (64, 16384) against it
    return [(b, n) for b in PLAN_B for n in PLAN_N if n < 9000 or b <= 33]


@pytest.mark.parametrize("b,n", _emulated_shapes())
def test_backward_emulation_matches_plain_exactly(b, n):
    """With a mask in {0, 1} every partial is an integer, so the kernels'
    split sums and scale give exactly the plain version's gradient, at
    every SM count's plan (ties included: sign(0) = 0)."""
    flat, m = _inputs(b, n, "random", seed=b + n)
    f, mt = torch.from_numpy(flat), torch.from_numpy(m)
    _, n_pairs = pairwise_l1_reference(f, mt)
    ct = torch.tensor(0.37)
    ref = pairwise_l1_backward_reference(f, mt, n_pairs, ct)
    for sms in PLAN_SMS:
        got = _emulate_backward(f, mt, n_pairs, ct,
                                pairwise_backward_plan(b, n, sms))
        assert torch.equal(got, ref), sms


@pytest.mark.cuda
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("b,n", [(1, 7), (2, 256), (33, 1), (256, 256),
                                 (64, 16384), (33, 9000), (8, 256),
                                 (16, 256), (17, 256), (31, 256), (32, 256),
                                 (128, 256), (257, 256), (37, 1001)])
def test_kernels_match_plain_on_card(b, n, mask):
    """Forward within rtol 1e-5, backward within atol 1e-6 of the plain
    versions; a second call is bit-identical (no float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flat, m = _inputs(b, n, mask)
    f = torch.from_numpy(flat).cuda().requires_grad_(True)
    mt = torch.from_numpy(m).cuda()
    launches = (pairwise_l1_mean.launches, pairwise_l1_mean.backward_launches)
    avg, n_pairs = pairwise_l1_mean(f, mt)
    (g,) = torch.autograd.grad(avg, f)
    torch.cuda.synchronize()
    assert (pairwise_l1_mean.launches - launches[0],
            pairwise_l1_mean.backward_launches - launches[1]) == (1, 1)
    ref_avg, ref_n = pairwise_l1_reference(f.detach(), mt)
    ref_g = pairwise_l1_backward_reference(f.detach(), mt, ref_n,
                                           torch.ones((), device="cuda"))
    assert float(n_pairs) == float(ref_n)
    torch.testing.assert_close(avg, ref_avg, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(g, ref_g, rtol=0, atol=1e-6)
    avg2, _ = pairwise_l1_mean(f, mt)
    (g2,) = torch.autograd.grad(avg2, f)
    assert torch.equal(avg, avg2) and torch.equal(g, g2)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f = torch.rand(4, 8, device="cuda")
    m = torch.ones(4, device="cuda")
    with pytest.raises(TypeError):
        pairwise_l1_mean(f.double(), m)
    with pytest.raises(ValueError):
        pairwise_l1_mean(f.t(), m)
    with pytest.raises(ValueError):
        pairwise_l1_mean(f, m[:3])
