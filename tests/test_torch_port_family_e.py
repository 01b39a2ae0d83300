"""Family E in the port against `cvad_tpu` on the CPU: the
`BBoxVizDetector` forward, a reference-format ``.pth`` through both
packages' loaders, the carry both ways, the scorer (float clips; the uint8
difference on its own), ``cli auc --family e`` and the presets.

Weights come from `cvad_tpu`'s own initialisation and are carried to the
port by `from_jax_family_e`.  Tolerances (float32 on both sides): scores
and adjacency within ATOL = 2e-5, features within FEAT_RTOL = 1e-4 of
their largest magnitude, AUCs within 1e-6.  Every input batch has
N_CLIPS = 5 clips, the batch a 24-frame video gives `VideoScorer`, so
each of `cvad_tpu`'s two family-E functions (the full forward here and its
scorer) compiles once.  The `cuda`-marked test runs the port on the card
against the port on the CPU and skips without a card.
"""

import json

import numpy as np
import pytest
import torch

from cvad_tpu_torch import cli
from cvad_tpu_torch.config import FamilyEConfig, preset
from cvad_tpu_torch.evaluation import frame_auc as fa
from cvad_tpu_torch.evaluation.scoring import make_score_fn
from cvad_tpu_torch.models import BBoxVizDetector
from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_e,
                                               load_torch_state_dict,
                                               to_jax_family_e)

ATOL = 2e-5
FEAT_RTOL = 1e-4
N_CLIPS = 5
CLIP = (8, 64, 64, 3)


@pytest.fixture(scope="module")
def J():
    """`cvad_tpu`'s side: the seeded variables, the jitted full forward
    and its family-E scorer."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.evaluation import frame_auc as jfa
    from cvad_tpu.evaluation.scoring import make_score_fn as jax_score_fn
    from cvad_tpu.models import BBoxVizDetector as JaxBBox
    from cvad_tpu.runtime import checkpoint as jckpt

    model = JaxBBox()
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(3), jnp.zeros((1,) + CLIP)))
    fwd = jax.jit(lambda v, x: model.apply(v, x))

    def forward(v, clips):
        with jax.default_matmul_precision("highest"):
            return [np.asarray(o) for o in fwd(v, jnp.asarray(clips))]

    return dict(jax=jax, variables=variables, forward=forward, ckpt=jckpt,
                score_fn=jax_score_fn("e", variables), fa=jfa,
                preset=jax_preset)


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(11).uniform(
        0, 1, (N_CLIPS,) + CLIP).astype(np.float32)


def _port_forward(state, clips):
    model = BBoxVizDetector()
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        x = torch.from_numpy(clips).permute(0, 4, 1, 2, 3).contiguous()
        return [o.numpy() for o in model.eval()(x)]


def _close(got, want):
    (s, adj, feats), (js, jadj, jfeats) = got, want
    assert s.shape == (N_CLIPS,) and adj.shape == (N_CLIPS, 16, 16)
    assert feats.shape == (N_CLIPS, 1024)
    np.testing.assert_allclose(s, js, rtol=0, atol=ATOL)
    np.testing.assert_allclose(adj, jadj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(feats, jfeats, rtol=0,
                               atol=FEAT_RTOL * np.abs(jfeats).max())


def test_forward_matches_jax(J, clips):
    """The forward on `cvad_tpu`'s weights: scores, adjacency and the
    channel-major features, whose order `cvad_tpu` reaches by a
    transpose."""
    state = from_jax_family_e(J["variables"])
    _close(_port_forward(state, clips), J["forward"](J["variables"], clips))


def test_reference_pth_loads_strict(J, clips, tmp_path):
    """The port's seeded init saved as a reference-format ``.pth``: the
    port loads it with ``strict=True`` (through `load_torch_state_dict`),
    and `cvad_tpu`'s ``import_torch_family_e`` of the same file gives the
    same forward."""
    model = BBoxVizDetector(seed=5)
    assert sorted(model.state_dict()) == sorted(
        f"{p}.{k}" for p in ("encoder.0", "encoder.3", "causal_net.0",
                             "causal_net.2", "classifier.0", "classifier.3")
        for k in ("weight", "bias"))
    assert sum(p.numel() for p in model.parameters()) == 517_505
    path = str(tmp_path / "e.pth")
    torch.save({"model_state_dict": model.state_dict()}, path)
    state = load_torch_state_dict(path)
    _close(_port_forward(state, clips),
           J["forward"](J["ckpt"].import_torch_family_e(path), clips))


def test_carry_round_trip(J):
    """`to_jax_family_e` inverts `from_jax_family_e`, both ways, exactly;
    it agrees with `cvad_tpu`'s ``export_family_e_torch_state``."""
    v = J["variables"]
    back = to_jax_family_e(from_jax_family_e(v))
    flat = J["jax"].tree_util.tree_leaves_with_path
    for (pa, a), (pb, b) in zip(flat(v), flat(back), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    state = BBoxVizDetector(seed=2).state_dict()
    again = from_jax_family_e(to_jax_family_e(state))
    exported = J["ckpt"].export_family_e_torch_state(to_jax_family_e(state))
    assert sorted(again) == sorted(state) == sorted(exported)
    for k in state:
        assert torch.equal(again[k], state[k])
        np.testing.assert_array_equal(exported[k], state[k].numpy())


def test_score_fn_matches_jax(J, clips):
    """``make_score_fn('e')`` on float clips in [0, 1] against `cvad_tpu`'s:
    scores only, within ATOL."""
    got = make_score_fn("e", from_jax_family_e(J["variables"]),
                        device="cpu")(clips)
    assert got.shape == (N_CLIPS,) and got.dtype == np.float32
    np.testing.assert_allclose(got, J["score_fn"](clips), rtol=0, atol=ATOL)
    assert make_score_fn("e", from_jax_family_e(J["variables"]),
                         device="cpu")(clips[:0]).shape == (0,)


def test_uint8_clips_are_divided_by_255(J, clips):
    """A known difference: the port's scorer divides uint8 clips by 255, as
    its other scorers do; `cvad_tpu`'s casts them without dividing, so it
    scores raw pixels (ROADMAP, Known differences)."""
    pixels = np.round(clips * 255).astype(np.uint8)
    port = make_score_fn("e", from_jax_family_e(J["variables"]),
                         device="cpu")
    np.testing.assert_allclose(port(pixels),
                               port(pixels.astype(np.float32) / 255),
                               rtol=0, atol=1e-7)
    raw = J["score_fn"](pixels)
    np.testing.assert_allclose(raw, J["score_fn"](pixels.astype(np.float32)),
                               rtol=0, atol=1e-7)
    assert np.abs(raw - port(pixels)).max() > 1e-3


def test_cli_auc_matches_jax(J, tmp_path, capsys):
    """``auc --family e --preset bbox_viz`` from a reference-format ``.pth``
    over a frame-folder tree (2 videos of 24 frames) against `cvad_tpu`'s
    frame AUC of its own scorer on the same weights: within 1e-6."""
    pytest.importorskip("sklearn")
    tree = str(tmp_path / "tree")
    assert cli.main(["synth", "--out", tree, "--videos", "2", "--frames",
                     "24", "--write-gt"]) == 0
    path = str(tmp_path / "e.pth")
    torch.save({"model_state_dict": from_jax_family_e(J["variables"])}, path)
    capsys.readouterr()
    assert cli.main(["auc", "--preset", "bbox_viz", "--data-root", tree,
                     "--torch-checkpoint", path, "--family", "e",
                     "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = J["fa"].dataset_frame_auc(J["score_fn"],
                                     J["preset"]("bbox_viz").data, tree)
    assert got["n_frames"] == 48 and got["n_videos"] == 2
    for k, v in got.items():
        assert (v is None and want[k] is None) or abs(want[k] - v) <= 1e-6, k
    # the port's own scorer through the library call agrees with the CLI
    port = fa.dataset_frame_auc(
        make_score_fn("e", load_torch_state_dict(path), device="cpu"),
        preset("bbox_viz").data, tree)
    assert {k: port[k] for k in got} == got


def test_presets_and_config(J):
    """bbox_viz, family_e and avenue_training_script_bbox name one config,
    field for field `cvad_tpu`'s; family E has no trainer."""
    from cvad_tpu_torch.config import family_of
    from cvad_tpu_torch.train.tasks import build_task

    names = ("bbox_viz", "family_e", "avenue_training_script_bbox")
    for name in names:
        cfg = preset(name)
        assert cfg == preset("bbox_viz") and family_of(cfg.model) == "e"
        assert cfg.model.to_dict() == J["preset"](name).model.to_dict()
    assert FamilyEConfig() == preset("bbox_viz").model
    with pytest.raises(NotImplementedError, match="no train task"):
        build_task(preset("bbox_viz"))
    with pytest.raises(KeyError):
        preset("family_f")


def test_seeded_init_draws_nothing_global():
    """The model's init is a function of its seed and leaves torch's
    global generator as it was."""
    torch.manual_seed(0)
    before = torch.rand(1)
    torch.manual_seed(0)
    a = BBoxVizDetector(seed=4).state_dict()
    assert torch.equal(torch.rand(1), before)
    b = BBoxVizDetector(seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.0.weight"],
                           BBoxVizDetector(seed=5).state_dict()[
                               "encoder.0.weight"])


@pytest.mark.cuda
def test_family_e_on_card(clips):
    """The scorer and the forward on the card against the port on the CPU,
    TF32 off: within ATOL (features within FEAT_RTOL of the largest); a
    second call bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cvad_tpu_torch.train.tasks import card_numerics

    state = BBoxVizDetector(seed=1).state_dict()
    cpu = make_score_fn("e", state, device="cpu")(clips)
    card_fn = make_score_fn("e", state)
    card = card_fn(clips)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=ATOL)
    assert np.array_equal(card, card_fn(clips))
    want = _port_forward(state, clips)
    model = BBoxVizDetector().cuda().eval()
    model.load_state_dict(state, strict=True)
    x = torch.from_numpy(clips).cuda().permute(0, 4, 1, 2, 3).contiguous()
    with torch.no_grad(), card_numerics():
        got = [o.cpu().numpy() for o in model(x)]
    _close(got, want)
