"""Family D's loss in the port against `cvad_tpu.ops.losses` on the CPU:
every component of `improved_loss` and the gradients w.r.t. the scores and
the adjacency, with and without a `valid` mask, and the focal / binary
cross-entropy terms.

Adjacencies here are uniform in (0, 1) with no exact ties between samples:
at a tie the two frameworks differentiate |x| differently (see
tests/test_torch_port_pairwise.py::test_ties_differ_from_jax_only_where_tied).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # cvad_tpu's package imports
import jax.numpy as jnp  # noqa: E402

from cvad_tpu.config import LossConfig as JaxLossConfig  # noqa: E402
from cvad_tpu.ops import losses as jl  # noqa: E402
from cvad_tpu_torch.config import LossConfig  # noqa: E402
from cvad_tpu_torch.ops import losses as pl  # noqa: E402

KEYS = ("anomaly_loss", "acyclicity_loss", "sparsity_loss",
        "consistency_loss", "structure_loss", "edge_count", "sparsity_ratio")


def _batch(b=6, d=16, seed=0, targets=None):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0.01, 0.99, (b, 1)).astype(np.float32)
    # edges around the 0.1 threshold and a band-crossing edge count
    adj = (rng.uniform(0, 1, (b, d, d)) ** 3).astype(np.float32)
    t = (rng.uniform(size=b) < 0.3).astype(np.float32) if targets is None \
        else np.asarray(targets, np.float32)
    return scores, adj, t


def _jax(scores, adj, t, valid=None, cfg=JaxLossConfig()):
    v = None if valid is None else jnp.asarray(valid)

    def f(s, a):
        return jl.improved_loss(s, a, jnp.asarray(t), cfg, valid=v)

    (total, comps), (gs, ga) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(scores),
                                         jnp.asarray(adj))
    return (float(total), {k: float(comps[k]) for k in KEYS},
            np.asarray(gs), np.asarray(ga))


def _port(scores, adj, t, valid=None, cfg=LossConfig()):
    s = torch.from_numpy(scores).requires_grad_(True)
    a = torch.from_numpy(adj).requires_grad_(True)
    v = None if valid is None else torch.from_numpy(np.asarray(valid))
    total, comps = pl.improved_loss(s, a, torch.from_numpy(t), cfg, valid=v)
    gs, ga = torch.autograd.grad(total, (s, a))
    return (float(total.detach()), {k: float(comps[k].detach()) for k in KEYS},
            gs.numpy(), ga.numpy())


def _compare(j, p):
    """rtol 1e-5 on values (f32 sums in another order; edge_count is an
    exact count); atol 1e-7 on gradients, whose largest entries are ~1e-2
    (the focal term over B rows) and smallest ~1e-7 (the consistency term,
    weight 0.01 / (n_pairs * 256))."""
    np.testing.assert_allclose(p[0], j[0], rtol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(p[1][k], j[1][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(p[2], j[2], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p[3], j[3], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_improved_loss_matches_jax(seed):
    batch = _batch(seed=seed)
    _compare(_jax(*batch), _port(*batch))


def test_improved_loss_band_and_weights():
    """Few edges (below the band's minimum) and non-default weights."""
    s, a, t = _batch(b=4, seed=2)
    a = (a * 0.12).astype(np.float32)
    kw = dict(consistency_weight=0.5, structure_weight=0.2, min_edges=30,
              consistency_target=0.02)
    _compare(_jax(s, a, t, cfg=JaxLossConfig(**kw)),
             _port(s, a, t, cfg=LossConfig(**kw)))


def test_padded_batch_matches_jax_and_its_real_rows():
    """With `valid`, padded rows leave every term; the result equals the
    real rows alone."""
    s, a, t = _batch(b=8, seed=3)
    valid = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    j, p = _jax(s, a, t, valid), _port(s, a, t, valid)
    _compare(j, p)
    real = _port(s[:5], a[:5], t[:5])
    np.testing.assert_allclose(p[0], real[0], rtol=1e-6)
    np.testing.assert_allclose(p[3][:5], real[3], rtol=1e-5, atol=1e-8)
    assert not p[3][5:].any()


@pytest.mark.parametrize("targets", [[1, 1, 1, 1], [0, 1, 1, 1]])
def test_no_normal_pairs(targets):
    """No pair of normal rows: the consistency term is 0 in both."""
    batch = _batch(b=4, seed=4, targets=targets)
    j, p = _jax(*batch), _port(*batch)
    assert p[1]["consistency_loss"] == 0.0 == j[1]["consistency_loss"]
    _compare(j, p)


def test_focal_and_bce_match_jax():
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 1, 64).astype(np.float32)
    p[:3] = (0.0, 1.0, 1e-9)  # clipped to [1e-7, 1 - 1e-7]
    t = (rng.uniform(size=64) < 0.5).astype(np.float32)
    valid = (rng.uniform(size=64) < 0.7).astype(np.float32)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    np.testing.assert_allclose(
        pl.binary_cross_entropy(pt, tt).numpy(),
        np.asarray(jl.binary_cross_entropy(jnp.asarray(p), jnp.asarray(t))),
        rtol=1e-6)
    for v in (None, valid):
        got = pl.focal_bce(pt, tt, 0.25, 2.0,
                           None if v is None else torch.from_numpy(v))
        ref = jl.focal_bce(jnp.asarray(p), jnp.asarray(t), 0.25, 2.0,
                           None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_pseudo_labels_rate():
    """The draws differ from JAX's (other bits), the rule does not:
    uniform > 1 - rate, from the generator given."""
    g = torch.Generator().manual_seed(3)
    labels = pl.pseudo_labels(g, 20000, 0.05)
    assert labels.dtype == torch.float32
    assert set(labels.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(labels.mean()) - 0.05) < 0.01
    again = pl.pseudo_labels(torch.Generator().manual_seed(3), 20000, 0.05)
    assert torch.equal(labels, again)
