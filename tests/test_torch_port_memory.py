"""K3, the memory-bank min cosine distance: the port's plain version (the
CPU path of `memory_min_cosine_distance`) against `cvad_tpu`'s Pallas kernel
in interpret mode and its XLA expression, the min-fill gate, the gradient
against `jax.grad`, the CUDA kernels' launch plan (`memory_plan`) and an
emulation of what they compute under it, and the CUDA kernels against the
plain version on a card.

JAX and `cvad_tpu` are imported inside the tests that use them, so that the
card tests run on a machine without flax.
"""

import functools

import numpy as np
import pytest
import torch

from cvad_tpu_torch.models.family_b import (MemoryBankState,
                                            memory_anomaly_score)
from cvad_tpu_torch.ops.pallas_kernels import (
    MEM_CHUNK_ALIGN, MEM_TILES, memory_distance_xla_reference,
    memory_min_cosine_distance, memory_min_cosine_distance_reference,
    memory_plan)


def _inputs(b, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


def _fills(m):
    return sorted({0, 1, m // 2, m})


def _port(q, mem, fill):
    return memory_min_cosine_distance(
        torch.from_numpy(q), torch.from_numpy(mem),
        torch.tensor(fill, dtype=torch.int32)).numpy()


@functools.lru_cache(maxsize=None)
def _jax_fns():
    import jax

    from cvad_tpu.ops.pallas_kernels import memory_min_cosine_distance as jk

    interp = jax.jit(lambda q, m, f: jk(q, m, f, interpret=True))
    xla = jax.jit(lambda q, m, f: jk(q, m, f, use_pallas=False))
    return jk, interp, xla


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("m", [1, 8, 50])
@pytest.mark.parametrize("b", [1, 7, 33])
def test_plain_matches_pallas_interpret(b, m, d):
    """Every fill in {0, 1, M/2, M}: within 1e-6 of the Pallas kernel in
    interpret mode (as tests/test_pallas.py runs it) and of
    ``use_pallas=False``.  The results are one float32 min of dot products
    of length D; the two normalisations differ by a rounding."""
    pytest.importorskip("flax")
    import jax.numpy as jnp

    _, interp, xla = _jax_fns()
    q, mem = _inputs(b, m, d, seed=b * 100 + m + d)
    q[0] = 0.0  # a zero query row: distance 1 to every row, 0.5 scaled
    for fill in _fills(m):
        got = _port(q, mem, fill)
        f = jnp.int32(fill)
        np.testing.assert_allclose(got, np.asarray(interp(q, mem, f)),
                                   rtol=0, atol=1e-6, err_msg=f"fill {fill}")
        np.testing.assert_allclose(got, np.asarray(xla(q, mem, f)),
                                   rtol=0, atol=1e-6, err_msg=f"fill {fill}")
        assert got.shape == (b,) and got.dtype == np.float32
        assert got[0] == pytest.approx(0.5 if fill else 1.0)
    assert np.all(_port(q, mem, 0) == 1.0)


def test_nan_rows_propagate_as_in_jax():
    """A NaN query row scores NaN; a NaN memory row below the fill makes
    every score NaN, one at or beyond it is never read."""
    pytest.importorskip("flax")
    import jax.numpy as jnp

    _, interp, _ = _jax_fns()
    q, mem = _inputs(5, 8, 16, seed=4)
    q[2, 3] = np.nan
    got = _port(q, mem, 6)
    ref = np.asarray(interp(q, mem, jnp.int32(6)))
    assert np.isnan(got[2]) and np.isnan(ref[2])
    assert np.isfinite(np.delete(got, 2)).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    q[2, 3] = 1.0
    mem[7] = np.nan
    assert np.isfinite(_port(q, mem, 7)).all()
    mem[1] = np.nan
    assert np.isnan(_port(q, mem, 7)).all()
    assert np.isnan(np.asarray(interp(q, mem, jnp.int32(7)))).all()


def test_xla_twin_differs_only_at_tiny_norms():
    """The twin of `_memory_xla` normalises by max(||x||, 1e-8), the plain
    version by rsqrt(||x||^2 + 1e-8): equal at ordinary norms, apart at
    norms near 1e-4 and below."""
    q, mem = _inputs(6, 10, 16, seed=5)
    qt, mt = torch.from_numpy(q), torch.from_numpy(mem)
    fill = torch.tensor(10, dtype=torch.int32)
    torch.testing.assert_close(memory_distance_xla_reference(qt, mt, fill),
                               memory_min_cosine_distance_reference(
                                   qt, mt, fill), rtol=0, atol=1e-6)
    tiny = qt * 1e-5
    a = memory_distance_xla_reference(tiny, mt, fill)
    b = memory_min_cosine_distance_reference(tiny, mt, fill)
    assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("fill", [0, 3, 9, 10, 24])
def test_min_fill_gate(fill):
    """`memory_anomaly_score` is 0 for every row until `min_fill` slots are
    filled, K3's score from then on: as `cvad_tpu`'s."""
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from cvad_tpu.models.family_b import MemoryBankState as JaxState
    from cvad_tpu.models.family_b import memory_anomaly_score as jax_score

    q, mem = _inputs(4, 24, 16, seed=6)
    state = MemoryBankState(torch.from_numpy(mem),
                            torch.tensor(fill % 24, dtype=torch.int32),
                            torch.tensor(fill, dtype=torch.int32))
    got = memory_anomaly_score(state, torch.from_numpy(q), 10).numpy()
    ref = np.asarray(jax_score(JaxState(jnp.asarray(mem), jnp.int32(fill % 24),
                                        jnp.int32(fill)), jnp.asarray(q), 10))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got == 0).all() == (fill < 10)


@pytest.mark.parametrize("b,m,d,fill", [(5, 12, 16, 12), (9, 30, 64, 17),
                                        (1, 1, 8, 1)])
def test_gradient_matches_jax_grad(b, m, d, fill):
    """The gradient w.r.t. query and memory against `jax.grad` of the
    interpret path (whose custom VJP runs through `_memory_xla`), within
    1e-5, on random inputs, where no row has a tied minimum."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    jk, _, _ = _jax_fns()
    q, mem = _inputs(b, m, d, seed=7 + b)
    w = np.random.default_rng(8).normal(size=b).astype(np.float32)

    def loss(qq, mm):
        return jnp.sum(jk(qq, mm, jnp.int32(fill), interpret=True) * w)

    ref_q, ref_m = jax.grad(loss, argnums=(0, 1))(jnp.asarray(q),
                                                  jnp.asarray(mem))
    qt = torch.from_numpy(q).requires_grad_(True)
    mt = torch.from_numpy(mem).requires_grad_(True)
    out = memory_min_cosine_distance(qt, mt, torch.tensor(fill,
                                                          dtype=torch.int32))
    gq, gm = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, mt))
    np.testing.assert_allclose(gq.numpy(), np.asarray(ref_q), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), np.asarray(ref_m), rtol=0,
                               atol=1e-5)
    assert not gm[fill:].any()  # rows beyond the fill get no gradient


def test_cpu_path_launches_nothing_and_checks_shapes():
    before = memory_min_cosine_distance.launches
    q, mem = _inputs(3, 4, 8)
    _port(q, mem, 2)
    assert memory_min_cosine_distance.launches == before
    with pytest.raises(ValueError, match="query must be"):
        memory_min_cosine_distance(torch.zeros(3, 8), torch.zeros(4, 7), 2)
    with pytest.raises(ValueError, match="one count"):
        memory_min_cosine_distance(torch.zeros(3, 8), torch.zeros(4, 8),
                                   torch.zeros(2, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,m", [(1, 1), (7, 10), (256, 500), (1024, 4096)])
def test_kernel_matches_plain_on_card(b, m, d):
    """Every fill in {0, 1, M/2, M}: within atol 1e-6 of the plain version,
    one launch each, and a second call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, mem = (torch.from_numpy(a).cuda() for a in _inputs(b, m, d))
    for fill in _fills(m):
        f = torch.tensor(fill, dtype=torch.int32, device="cuda")
        before = memory_min_cosine_distance.launches
        got = memory_min_cosine_distance(q, mem, f)
        again = memory_min_cosine_distance(q, mem, f)
        torch.cuda.synchronize()
        assert memory_min_cosine_distance.launches == before + 2
        ref = memory_min_cosine_distance_reference(q, mem, f)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel_nan_and_limits_on_card():
    """NaN rows propagate; the kernel takes widths past one 1,024-wide chunk
    of D (it had a cap there) and an empty D still raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, mem = (torch.from_numpy(a).cuda() for a in _inputs(4, 9, 32))
    q[1, 0] = float("nan")
    got = memory_min_cosine_distance(q, mem, 9)
    assert torch.isnan(got[1]) and torch.isfinite(got[[0, 2, 3]]).all()
    q, mem = (torch.from_numpy(a).cuda() for a in _inputs(2, 3, 1025))
    f = torch.tensor(3, dtype=torch.int32, device="cuda")
    torch.testing.assert_close(memory_min_cosine_distance(q, mem, f),
                               memory_min_cosine_distance_reference(q, mem, f),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        memory_min_cosine_distance(torch.zeros(2, 0, device="cuda"),
                                   torch.zeros(3, 0, device="cuda"), 1)


# ---------------------------------------------------------------------------
# the kernel's launch plan (pure Python) and an emulation of what the three
# kernels compute under it
# ---------------------------------------------------------------------------

H100_SMS = 132
# the shapes chip_smoke.py times (MEM_SHAPES, MEM_WIDE, MEM_ATTN)
TIMED = [(256, 500, 64), (1024, 4096, 128), (16, 500, 2048), (8, 64, 4096),
         (16, 500, 128)]
PLANNED = TIMED + [(1, 1, 1), (1, 500, 64), (7, 10, 1025), (33, 70, 100),
                   (65, 65, 65), (600, 1500, 33), (1024, 1, 64), (3, 7, 8)]


@pytest.mark.parametrize("b,m,d", PLANNED)
def test_memory_plan_covers_every_row_and_column(b, m, d):
    """The tiles kernel's grid covers every query row, bank row and column
    of D exactly once (chunks of a multiple of 16, the last no wider), the
    scratch holds the inverse norms and the partials, and the grid fits
    CUDA's limits."""
    plan = memory_plan(b, m, d, H100_SMS)
    bq, bm = MEM_TILES[plan.tile]
    gm, gq, gz = plan.grid
    assert (gm - 1) * bm < m <= gm * bm
    assert (gq - 1) * bq < b <= gq * bq and gq <= 65535
    assert gz == plan.splits and plan.chunk % MEM_CHUNK_ALIGN == 0
    assert (plan.splits - 1) * plan.chunk < d <= plan.splits * plan.chunk
    parts = plan.splits * b * m if plan.splits > 1 else gm * b
    assert plan.scratch == b + m + parts


@pytest.mark.parametrize("b,m,d", TIMED)
def test_memory_plan_fills_the_card(b, m, d):
    """At every timed shape the grid has a block per SM of the H100, or D
    is already cut into the narrowest chunks; the main path's (256, 500,
    64) and the large bank keep D whole."""
    plan = memory_plan(b, m, d, H100_SMS)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= H100_SMS or plan.chunk == MEM_CHUNK_ALIGN
    assert blocks >= 0.9 * H100_SMS
    if (b, m, d) in [(256, 500, 64), (1024, 4096, 128)]:
        assert plan.splits == 1


def _emulate(q, mem, fill, plan):
    """What the norms, tiles and combine kernels compute under `plan`, in
    float32 numpy: partial minima over the bank tiles below the fill, or
    partial dot products over the chunks of D summed in split order."""
    b, d = q.shape
    m = mem.shape[0]
    _, bm = MEM_TILES[plan.tile]
    f = min(max(fill, 0), m)
    inv_q = (1 / np.sqrt((q * q).sum(1) + np.float32(1e-8))).astype(
        np.float32)
    inv_m = (1 / np.sqrt((mem * mem).sum(1) + np.float32(1e-8))).astype(
        np.float32)

    def dist(dot, cols):
        s = dot * inv_q[:, None] * inv_m[None, cols]
        return 1 - np.clip(s, -1, 1)

    best = np.full(b, 3.0, np.float32)
    if plan.splits == 1:
        for t in range(plan.grid[0]):
            cols = np.arange(t * bm, min((t + 1) * bm, f))
            if t * bm >= f:
                continue  # the block exits at once
            best = np.minimum(best, dist(q @ mem[cols].T, cols).min(1))
    elif f:
        dot = np.zeros((b, f), np.float32)
        for z in range(plan.splits):
            ks = slice(z * plan.chunk, (z + 1) * plan.chunk)
            dot = dot + q[:, ks] @ mem[:f, ks].T
        best = np.minimum(best, dist(dot, np.arange(f)).min(1))
    return np.clip(best, 0, 2) / 2


@pytest.mark.parametrize("b,m,d", [(33, 70, 100), (5, 33, 2048),
                                   (65, 65, 65), (200, 150, 64)])
@pytest.mark.parametrize("sms", [4, H100_SMS])
def test_plan_emulation_matches_plain(b, m, d, sms):
    """The plan's partials (minima by bank tile, or dot products by chunk
    of D), combined as the kernels combine them, give the plain version
    within 1e-6 at fills 0, 1, inside a bank tile and M: the plan drops
    no row, column or chunk, and masks the fill where the kernels do."""
    q, mem = _inputs(b, m, d, seed=b + m + d)
    plan = memory_plan(b, m, d, sms)
    for fill in sorted({0, 1, min(m, 37), m}):
        ref = memory_min_cosine_distance_reference(
            torch.from_numpy(q), torch.from_numpy(mem),
            torch.tensor(fill)).numpy()
        np.testing.assert_allclose(_emulate(q, mem, fill, plan), ref,
                                   rtol=0, atol=1e-6, err_msg=f"{fill}")


# K3 on the card at its tile edges: B, M and D no multiple of a tile, D =
# 1025 (4-byte pieces), 2048 and 4096, a fill inside a bank tile, and every
# plan kind (tile, split of D or not, piece width)
CARD_EDGES = [(33, 70, 100), (65, 65, 65), (17, 97, 1025), (130, 300, 1025),
              (5, 33, 2048), (1, 500, 4096), (200, 700, 37),
              (600, 1500, 33), (3, 7, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d", CARD_EDGES)
def test_kernel_tile_edges_on_card(b, m, d):
    """At fills {0, 1, 37, M}: within 1e-6 of the plain version, a second
    call bit-identical, one count a call, and a NaN query row NaN alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, mem = (torch.from_numpy(a).cuda() for a in _inputs(b, m, d, seed=3))
    q[b // 2, d // 3] = float("nan")
    rest = [i for i in range(b) if i != b // 2]
    for fill in sorted({0, 1, min(m, 37), m}):
        f = torch.tensor(fill, dtype=torch.int32, device="cuda")
        before = memory_min_cosine_distance.launches
        got = memory_min_cosine_distance(q, mem, f)
        again = memory_min_cosine_distance(q, mem, f)
        torch.cuda.synchronize()
        assert memory_min_cosine_distance.launches == before + 2
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        ref = memory_min_cosine_distance_reference(q, mem, f)
        torch.testing.assert_close(got[rest], ref[rest], rtol=0, atol=1e-6)
        if fill:
            assert torch.isnan(got[b // 2]) and torch.isfinite(got[rest]).all()
