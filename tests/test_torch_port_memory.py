"""K3, the memory-bank min cosine distance: the port's plain version (the
CPU path of `memory_min_cosine_distance`) against `cvad_tpu`'s Pallas kernel
in interpret mode and its XLA expression, the min-fill gate, the gradient
against `jax.grad`, and the CUDA kernel against the plain version on a card.

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
    memory_distance_xla_reference, memory_min_cosine_distance,
    memory_min_cosine_distance_reference)


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
