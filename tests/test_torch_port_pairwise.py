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

from cvad_tpu_torch.ops.pallas_kernels import (pairwise_l1_backward_reference,
                                               pairwise_l1_mean,
                                               pairwise_l1_reference)

MASKS = ("zero", "single", "random", "one")


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


@pytest.mark.cuda
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("b,n", [(1, 7), (2, 256), (33, 1), (256, 256)])
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
