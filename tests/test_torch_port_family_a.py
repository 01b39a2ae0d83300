"""Family A in the port against `cvad_tpu` on the CPU: the
`CausalPipelineDetector` forward in both variants (eval, and train mode
with `cvad_tpu`'s VAE draw, BatchNorm statistics included), the carry both
ways against `cvad_tpu`'s reference importer, the GRU's reference biases,
`family_a_loss`, `family_a_test_analysis` and the eval metrics, and the
family-A scorer.

The model is the preset's at full width (channels 32-256, the pool at
(4, 6), 6,144 features) on small frames: 2 clips of 4 frames of 32x48,
where the backbone's last map (1x2) is smaller than the pool, so the
adaptive pool repeats windows, and the feature permutation of the carry is
not trivial.  Weights come from the port's initialisation and are carried
to `cvad_tpu` by `to_jax_family_a`.

Decisions: the detector's validity thresholds, the anchor head's 0.5
confidence cut and ``any`` over time are decisions that float rounding
could flip between the frameworks.  The masks must be equal, and each test
asserts its margin first: no box coordinate within MARGIN of a threshold,
no confidence within CONF_MARGIN of 0.5.  Besides the preset's
initialisation (every box saturates off the frame, the fallback box in
slot 0), a `mixed` detector (its head scaled so that boxes cross the
thresholds from frame to frame) gives masks that differ by frame and slot
and a nonzero adjacency.
"""

import functools

import numpy as np
import pytest
import torch

import cvad_tpu_torch.models.family_a as family_a
from cvad_tpu_torch.config import FamilyAConfig, preset
from cvad_tpu_torch.models import CausalPipelineDetector
from cvad_tpu_torch.runtime.checkpoint import (family_a_feature_permutation,
                                               from_jax_family_a,
                                               to_jax_family_a)

B, T, H, W = 2, 4, 32, 48
MARGIN = 1e-3       # box coordinates (pixels) from each threshold
CONF_MARGIN = 1e-5  # anchor confidences from 0.5
ANCHOR = FamilyAConfig(anchor_variant=True, direct_variant=False)
# every output's tolerance against cvad_tpu (float32 on both sides)
ATOL = {"anomaly_scores": 1e-6, "causal_anomaly_scores": 1e-6,
        "direct_predictions": 1e-6, "causal_factors": 1e-5,
        "adjacency_matrices": 1e-6, "structure_params": 0.0,
        "kl_losses": 1e-5, "detections": 1e-3}


def _jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    return jax


def jax_config(cfg: FamilyAConfig):
    from cvad_tpu.config import FamilyAConfig as JaxFamilyAConfig

    return JaxFamilyAConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg.to_dict().items()})


@functools.lru_cache(maxsize=None)
def _jax_model(cfg: FamilyAConfig):
    _jax()
    from cvad_tpu.models import CausalPipelineDetector as JaxDetector

    return JaxDetector(jax_config(cfg))


def clips(seed: int = 0, b: int = B) -> np.ndarray:
    """(b, T, H, W, 1) clips in [0, 1], each frame at its own brightness,
    so that the features (and the mixed detector's boxes) differ by
    frame."""
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.1, 1.0, (b, T, 1, 1, 1))
    return (rng.uniform(0, 1, (b, T, H, W, 1)) * gain).astype(np.float32)


def frames(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 1, 4, 2, 3).contiguous()


def model(cfg: FamilyAConfig = FamilyAConfig(), seed: int = 1,
          mixed: bool = False) -> CausalPipelineDetector:
    """A port model, dropout off; `mixed` scales the detector head by 2,000
    and biases the x of slots 1 and 2 so that validity varies."""
    m = CausalPipelineDetector(cfg, seed=seed)
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    if mixed:
        head = m.detector.detector_net[10]
        with torch.no_grad():
            head.weight.mul_(2000.0)
            bias = torch.zeros_like(head.bias)
            bias[4], bias[8] = 3.7, 1.5
            head.bias.copy_(bias)
    return m


def assert_margins(out) -> None:
    """No box coordinate of a masked detector's `out` lies within MARGIN
    of a validity threshold (the anchor head's decisions are its
    confidences: `anchor_conf_margin`)."""
    if out["detections"].shape[-2] == family_a.ANCHORS:
        return
    det = out["detections"].detach().double()
    x, y = det[..., 0], det[..., 1]
    near = torch.stack([(x - 10).abs(), (x - 350).abs(), (y - 10).abs(),
                        (y - 230).abs()]).min()
    assert float(near) > MARGIN, f"a box lies {float(near)} from a threshold"


def anchor_conf_margin(m: CausalPipelineDetector, x: torch.Tensor) -> float:
    """The smallest |confidence - 0.5| of the anchor head on `x`."""
    with torch.no_grad():
        feats = m.backbone(x)
        conf = torch.sigmoid(m.detector.conf_head(feats))
    return float((conf.double() - 0.5).abs().min())


@pytest.mark.parametrize("variant", ["init", "mixed", "anchor"])
def test_forward_matches_jax(variant):
    """Eval mode (z = mu) from the same weights: every output within ATOL
    (the boxes in pixels), the detection and trajectory masks equal."""
    jax = _jax()
    import jax.numpy as jnp

    cfg = ANCHOR if variant == "anchor" else FamilyAConfig()
    m = model(cfg, mixed=variant == "mixed").eval()
    x = clips()
    with torch.no_grad():
        got = m(frames(x))
    if variant == "anchor":
        assert anchor_conf_margin(m, frames(x)) > CONF_MARGIN
    assert_margins(got)
    v = to_jax_family_a(m.state_dict(), cfg)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x: _jax_model(cfg).apply(v, x))(
            v, jnp.asarray(x))
    assert sorted(got) == sorted(want)
    for k in ("detection_mask", "trajectory_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k, tol in ATOL.items():
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=tol,
                                   err_msg=k)
    mask = got["detection_mask"].numpy()
    if variant == "init":  # every box off the frame: the fallback box
        assert mask[..., 0].all() and not mask[..., 1:].any()
        np.testing.assert_array_equal(got["detections"][..., 0, :].numpy(),
                                      np.broadcast_to(family_a.FALLBACK_BOX,
                                                      (B, T, 4)))
    else:
        assert 0 < mask.mean() < 1 and mask.any(-1).all()
        assert not got["trajectory_mask"].all()
        assert float(got["adjacency_matrices"].abs().max()) > 0.1


def test_train_forward_matches_jax(monkeypatch):
    """Train mode from the same weights, dropout off on both sides, the
    port's VAE draw replaced by `cvad_tpu`'s own (``jax.random.normal`` of
    its key): outputs within ATOL and the running statistics of every
    BatchNorm within 1e-5 relative and 1e-6 absolute."""
    jax = _jax()
    import flax.linen as fnn
    import jax.numpy as jnp

    cfg = FamilyAConfig()
    m = model(cfg, mixed=True).train()
    v = to_jax_family_a(m.state_dict(), cfg)
    x = clips(3)
    key = jax.random.key(7)
    noise = np.array(jax.random.normal(key, (B, cfg.max_boxes,
                                             cfg.num_factors)))
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    with jax.default_matmul_precision("highest"):
        want, mutated = jax.jit(lambda v, x, key: _jax_model(cfg).apply(
            v, x, rng=key, train=True, deterministic=False,
            mutable=["batch_stats"]))(v, jnp.asarray(x), key)
    # `v` may alias the port model's buffers, which its train forward
    # below updates in place: JAX must have read them first
    jax.block_until_ready((want, mutated))
    monkeypatch.setattr(family_a, "vae_noise",
                        lambda shape, dtype, device, gen:
                        torch.from_numpy(noise).to(device, dtype))
    got = m(frames(x))
    assert_margins(got)
    for k in ("detection_mask", "trajectory_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k, tol in ATOL.items():
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0,
                                   atol=max(tol, 1e-6), err_msg=k)
    ours = to_jax_family_a(m.state_dict(), cfg)["batch_stats"]
    theirs = jax.device_get(mutated["batch_stats"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(ours)[0]:
        ref = theirs
        for p in path:
            ref = ref[p.key]
        np.testing.assert_allclose(leaf, np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("variant", ["enhanced", "anchor"])
def test_carry_matches_reference_importer(variant):
    """`to_jax_family_a` gives `cvad_tpu`'s tree (every key and shape of
    its ``init``) and the same values as `cvad_tpu`'s reference importer
    ``import_torch_family_a`` reading the port's state dict; the carry back
    is exact.  The feature permutation moves rows (a (4, 6) map of 256
    channels), so a carry without it would differ."""
    jax = _jax()
    import jax.numpy as jnp
    from cvad_tpu.runtime.checkpoint import import_torch_family_a

    cfg = ANCHOR if variant == "anchor" else FamilyAConfig()
    m = model(cfg, seed=4)
    with torch.no_grad():
        for name, buf in m.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5)
    state = m.state_dict()
    ours = to_jax_family_a(state, cfg)
    shapes = jax.eval_shape(
        functools.partial(_jax_model(cfg).init, train=True),
        jax.random.key(0), jnp.zeros((1, T, H, W, 1)))
    flat = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert {k: np.shape(v) for k, v in flat.items()} == {
        k: s.shape for k, s in jax.tree_util.tree_flatten_with_path(
            shapes)[0]}
    imported = import_torch_family_a(
        {k: v.numpy() for k, v in state.items()},
        variant="anchor" if variant == "anchor" else "enhanced")
    for k, v in jax.tree_util.tree_flatten_with_path(imported)[0]:
        np.testing.assert_array_equal(v, flat[k], err_msg=str(k))
    perm = family_a_feature_permutation((4, 6), 256)
    assert (perm != np.arange(perm.size)).mean() > 0.99
    back = from_jax_family_a(ours, cfg)
    assert set(back) == set(state)
    for k, v in state.items():
        if "num_batches" not in k:
            assert torch.equal(back[k], v), k


def test_reference_gru_biases_load():
    """A reference state dict holds ``nn.GRU``'s two biases: its r and z
    hidden biases join the input ones (the GRU's output is unchanged), the
    n hidden bias stays inside the reset term, and `cvad_tpu`'s importer
    reads the same gates from either form."""
    _jax()
    from cvad_tpu.runtime.checkpoint import import_torch_family_a

    cfg = FamilyAConfig()
    m = model(cfg, seed=6)
    state = {k: v.clone() for k, v in m.state_dict().items()}
    key = "traj_encoder.gru.bias_hh_l0"
    rng = np.random.default_rng(8)
    state[key] = torch.from_numpy(rng.normal(size=state[key].shape).astype(
        np.float32))
    state["traj_encoder.gru.bias_ih_l0"] = torch.from_numpy(rng.normal(
        size=state[key].shape).astype(np.float32))
    loaded = CausalPipelineDetector(cfg)
    loaded.load_state_dict(state, strict=True)
    h = cfg.gru_hidden
    got = loaded.state_dict()
    assert not got[key][:2 * h].any()
    torch.testing.assert_close(got[key][2 * h:], state[key][2 * h:])
    torch.testing.assert_close(
        got["traj_encoder.gru.bias_ih_l0"][:2 * h],
        state["traj_encoder.gru.bias_ih_l0"][:2 * h] + state[key][:2 * h])
    seq = torch.from_numpy(rng.normal(size=(3, T, 68)).astype(np.float32))
    ref = torch.nn.GRU(68, h, batch_first=True)
    ref.load_state_dict({k.split(".")[-1]: v for k, v in state.items()
                         if k.startswith("traj_encoder.gru.")})
    with torch.no_grad():
        torch.testing.assert_close(loaded.traj_encoder.gru(seq),
                                   ref(seq)[1][0], rtol=0, atol=1e-6)
    a = import_torch_family_a({k: v.numpy() for k, v in state.items()})
    b = to_jax_family_a(got, cfg)
    for gate in ("ir", "iz", "in", "hr", "hz", "hn"):
        for leaf in a["params"]["traj_encoder"]["GRUCell_0"][gate]:
            np.testing.assert_allclose(
                b["params"]["traj_encoder"]["GRUCell_0"][gate][leaf],
                a["params"]["traj_encoder"]["GRUCell_0"][gate][leaf],
                rtol=0, atol=1e-6, err_msg=gate)


def test_loss_matches_jax():
    """`family_a_loss` on the same outputs and labels, with and without a
    padding mask, at the preset's and the anchor preset's weights: total
    and terms within 1e-6."""
    jax = _jax()
    import jax.numpy as jnp
    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.ops.losses import family_a_loss as jax_loss
    from cvad_tpu_torch.ops.losses import family_a_loss

    rng = np.random.default_rng(9)
    direct = rng.dirichlet((1.0, 1.0), size=6).astype(np.float32)
    direct[0] = (1.0, 0.0)  # the clip at 1e-7
    outs = {"direct_predictions": direct,
            "anomaly_scores": rng.uniform(size=6).astype(np.float32),
            "causal_anomaly_scores": rng.uniform(size=6).astype(np.float32),
            "kl_losses": rng.uniform(0, 2, size=6).astype(np.float32)}
    labels = np.array([1, 0, 1, 1, 0, 0], np.float32)
    for name in ("causal_pipeline", "causal_pipeline_v0"):
        lc, jlc = preset(name).loss, jax_preset(name).loss
        for valid in (None, np.array([1, 1, 0, 1, 1, 0], np.float32)):
            got, gc = family_a_loss(
                {k: torch.from_numpy(v) for k, v in outs.items()},
                torch.from_numpy(labels), lc,
                None if valid is None else torch.from_numpy(valid))
            want, wc = jax_loss({k: jnp.asarray(v) for k, v in outs.items()},
                                jnp.asarray(labels), jlc,
                                None if valid is None else jnp.asarray(valid))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
            for k in wc:
                np.testing.assert_allclose(float(gc[k]), float(wc[k]),
                                           rtol=1e-6, err_msg=k)
    assert preset("causal_pipeline_v0").loss.a_ce == 0.0


def test_eval_metrics_and_analysis_match_jax():
    """`family_a_test_analysis` equals `cvad_tpu`'s; the eval dict holds
    `cvad_tpu`'s binary metrics (scikit-learn) with ``val_acc`` their
    accuracy; ``val_acc`` is the preset's best metric."""
    _jax()
    pytest.importorskip("sklearn")
    from cvad_tpu.evaluation.metrics import binary_metrics as jax_binary
    from cvad_tpu.evaluation.metrics import \
        family_a_test_analysis as jax_analysis
    from cvad_tpu_torch.evaluation.metrics import (family_a_eval_metrics,
                                                   family_a_test_analysis)

    rng = np.random.default_rng(10)
    scores = rng.uniform(size=23).astype(np.float32)
    labels = (rng.uniform(size=23) < 0.4).astype(np.float32)
    direct = rng.dirichlet((1.0, 1.0), size=23).astype(np.float32)
    assert family_a_test_analysis(scores, labels, direct) == jax_analysis(
        scores, labels, direct)
    got = family_a_eval_metrics(scores, labels, direct)
    want = jax_binary(scores, labels)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert got["val_acc"] == want["accuracy"]
    assert got["analysis"] == jax_analysis(scores, labels, direct)
    assert preset("causal_pipeline").train.best_metric == "val_acc"


def test_scorer_matches_eval_forward():
    """``make_score_fn('a')`` on uint8 and float clips gives the eval
    forward's blended scores; the anchor variant's are its causal scores;
    an empty batch gives none."""
    from cvad_tpu_torch.evaluation.scoring import make_score_fn

    x = clips(11)
    for cfg in (FamilyAConfig(), ANCHOR):
        m = model(cfg, seed=12).eval()
        fn = make_score_fn("a", m.state_dict(), cfg=cfg, device="cpu")
        with torch.no_grad():
            want = m(frames(x))
        np.testing.assert_allclose(fn(x), want["anomaly_scores"].numpy(),
                                   rtol=0, atol=1e-7)
        u8 = (x * 255).round().astype(np.uint8)
        with torch.no_grad():
            want8 = m(frames(u8.astype(np.float32) / 255.0))
        np.testing.assert_allclose(fn(u8), want8["anomaly_scores"].numpy(),
                                   rtol=0, atol=1e-7)
        assert fn(x[:0]).shape == (0,)
    np.testing.assert_array_equal(want["anomaly_scores"].numpy(),
                                  want["causal_anomaly_scores"].numpy())
