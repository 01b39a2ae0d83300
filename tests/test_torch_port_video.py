"""The port's video scoring path against `cvad_tpu`'s on the CPU:
`VideoScorer` (windows, scores, frame curves, graphs), the anomalous-clip
extraction, frame-level AUC (the port's average-rank AUC against
scikit-learn's, ties included), `StreamingScorer` against `score_video`,
the trainer's batch scorer, and the CLI's ``synth``, ``score``, ``auc``,
``eval`` and ``train --dataset ucsd_ped2`` with ``--device cpu``.

Family D scores with the fixture checkpoint, read by `cvad_tpu` and carried
to the port by `from_jax_family_d`; family B with a narrow model initialised
by `cvad_tpu` and carried by `from_jax_family_b`, its bank partly filled.
Every video has 24 frames, so each family's JAX scorer compiles once.
`cvad_tpu`'s side comes from the fixture `J`, which skips where JAX, flax
or scikit-learn is absent; the `cuda`-marked twins need none of them: they
run the port on the card against the port on the CPU, and skip without a
card.
"""

import dataclasses
import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cvad_tpu_torch import cli
from cvad_tpu_torch.config import DataConfig, FamilyBConfig, preset
from cvad_tpu_torch.data.datasets import ClipDataset
from cvad_tpu_torch.data.frames import clip_windows, scan_video_folders
from cvad_tpu_torch.data.synthetic import write_synthetic_video_tree
from cvad_tpu_torch.evaluation import frame_auc as fa
from cvad_tpu_torch.evaluation.metrics import format_sample_table, roc_auc
from cvad_tpu_torch.evaluation.scoring import (VideoScorer,
                                               make_family_b_score_fn,
                                               make_family_d_score_fn)
from cvad_tpu_torch.evaluation.serving import ClipScoringService
from cvad_tpu_torch.evaluation.streaming import StreamingScorer
from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_b,
                                               from_jax_family_d,
                                               load_torch_state_dict)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/dyn_parity_d/ours/best_improved_model.pth")
NARROW = dict(conv_channels=(8, 16, 32, 32), latent_dim=16, lstm_hidden=16,
              memory_size=32)
FILL = 20
TOL = 1e-5
CFG_D = dict(channels=3, clip_len=8, stride=4, frame_size=(64, 64))


@pytest.fixture(scope="module")
def J():
    """`cvad_tpu`'s side of the comparisons (JAX, flax, scikit-learn)."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")  # cvad_tpu's models
    pytest.importorskip("sklearn")  # cvad_tpu's frame AUC
    import jax
    import jax.numpy as jnp

    from cvad_tpu import cli as jcli
    from cvad_tpu import config
    from cvad_tpu.evaluation import frame_auc, metrics, scoring
    from cvad_tpu.models import family_b
    from cvad_tpu.runtime.checkpoint import import_torch_family_d

    return SimpleNamespace(jax=jax, jnp=jnp, cli=jcli, config=config,
                           fa=frame_auc, metrics=metrics, sc=scoring,
                           fb=family_b, import_d=import_torch_family_d)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 videos a split, 24 gray 64x64 PGM frames, `_gt` mask folders."""
    root = tmp_path_factory.mktemp("video")
    return write_synthetic_video_tree(str(root / "t"), write_gt=True,
                                      videos_per_split=2,
                                      frames_per_video=24)


def _videos(tree: str) -> list:
    return [v for split in ("Train", "Test")
            for v in scan_video_folders(str(Path(tree) / split))]


@pytest.fixture(scope="module")
def family_d(J):
    """(cvad_tpu's scorer, the port's CPU scorer, the two data configs)
    with the fixture's weights."""
    variables = J.import_d(CKPT)
    state = from_jax_family_d(variables)
    return (J.sc.make_family_d_score_fn(variables),
            make_family_d_score_fn(state, device="cpu"),
            J.config.DataConfig(**CFG_D), DataConfig(**CFG_D))


@pytest.fixture(scope="module")
def family_b(J):
    """The same for a narrow family B initialised by `cvad_tpu`, FILL of
    its 32 bank rows filled, on memory_ae's data config."""
    jcfg = J.config.FamilyBConfig(**NARROW)
    model = J.fb.MemoryVideoAutoEncoder(jcfg)
    mem = J.fb.init_memory(jcfg.memory_size, jcfg.latent_dim)
    variables = J.jax.device_get(J.jax.jit(lambda k: model.init(
        k, J.jnp.zeros((1, 8, 64, 64, 1)), mem, train=True))(
            J.jax.random.key(0)))
    bank = np.zeros((jcfg.memory_size, jcfg.latent_dim), np.float32)
    bank[:FILL] = np.random.default_rng(3).normal(size=(FILL,
                                                        jcfg.latent_dim))
    memory = J.fb.MemoryBankState(J.jnp.asarray(bank), J.jnp.int32(FILL),
                                 J.jnp.int32(FILL))
    state = from_jax_family_b(variables, (bank, np.int32(FILL),
                                          np.int32(FILL)))
    return (J.sc.make_family_b_score_fn(variables, memory, model=model),
            make_family_b_score_fn(state, cfg=FamilyBConfig(**NARROW),
                                   device="cpu"),
            J.config.preset("memory_ae").data, preset("memory_ae").data)


def _jax(J, fn):
    def run(batch):
        with J.jax.default_matmul_precision("highest"):
            return fn(batch)
    return run


@pytest.mark.parametrize("family", ["d", "b"])
def test_score_video_matches_jax(J, request, tree, family):
    jfn, pfn, jcfg, pcfg = request.getfixturevalue(f"family_{family}")
    jscorer, scorer = J.sc.VideoScorer(_jax(J, jfn), jcfg), VideoScorer(pfn,
                                                                    pcfg)
    n = {"d": 5, "b": 9}[family]
    for _, frames in _videos(tree):
        want, got = jscorer.score_video(frames), scorer.score_video(frames)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["starts"], want["starts"])
        assert len(got["starts"]) == n
        for k in ("scores", "frame_scores", "graphs"):
            if k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=TOL)
        assert got["frame_scores"].shape == (24,)
        assert ("graphs" in got) == (family == "d")


def test_extract_anomalous_clips_matches_jax(J, tree, family_d):
    jfn, pfn, jcfg, pcfg = family_d
    root = str(Path(tree) / "Test")
    scores = np.sort(np.concatenate([
        VideoScorer(pfn, pcfg).score_video(f)["scores"]
        for _, f in scan_video_folders(root)]))
    # the threshold in the widest gap between the middle scores, far from
    # every window's score; the kept scores far from each other
    k = 3 + int(np.argmax(np.diff(scores[3:-3])))
    thr = float(scores[k:k + 2].mean())
    assert np.diff(scores).min() > 10 * TOL
    want = J.sc.VideoScorer(_jax(J, jfn), jcfg).extract_anomalous_clips(
        root, threshold=thr)
    got = VideoScorer(pfn, pcfg).extract_anomalous_clips(root, threshold=thr)
    assert 0 < len(got) < 10
    assert [(c.video, c.start, c.frames) for c in got] == \
        [(c.video, c.start, c.frames) for c in want]
    for g, w in zip(got, want):
        assert abs(g.score - w.score) <= TOL
        np.testing.assert_allclose(g.causal_graph, w.causal_graph, atol=TOL)
    capped = VideoScorer(pfn, pcfg).extract_anomalous_clips(
        root, threshold=thr, max_clips=2)
    assert [c.start for c in capped] == [c.start for c in got[:2]]


def _same_report(got: dict, want: dict, tol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in ("n_videos", "n_frames", "anomalous_frames", "skipped_videos"):
        assert got[k] == want[k]
    for k in ("frame_auc", "frame_auc_normalized", "macro_auc"):
        assert (got[k] is None) == (want[k] is None)
        if want[k] is not None:
            assert abs(got[k] - want[k]) <= tol
    assert sorted(got["per_video_auc"]) == sorted(want["per_video_auc"])
    for v, a in want["per_video_auc"].items():
        b = got["per_video_auc"][v]
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) <= tol


@pytest.mark.parametrize("family", ["d", "b"])
def test_dataset_frame_auc_matches_jax(J, request, tree, family):
    jfn, pfn, jcfg, pcfg = request.getfixturevalue(f"family_{family}")
    want = J.fa.dataset_frame_auc(_jax(J, jfn), jcfg, tree)
    got = fa.dataset_frame_auc(pfn, pcfg, tree)
    _same_report(got, want, 1e-6)
    assert got["n_videos"] == 2 and got["n_frames"] == 48
    assert got["anomalous_frames"] == 12
    assert got["per_video_auc"]["Test002"] is None  # a normal video


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_level_auc_with_ties(J, seed):
    """Curves quantised to 3-5 levels (most frames tie), a video of one
    class and one without ground truth: the port's report equals
    scikit-learn's."""
    rng = np.random.default_rng(seed)
    videos, curves, gt = [], {}, {}
    for v in range(4):
        name, n = f"v{v}", int(rng.integers(20, 40))
        videos.append((name, [f"{name}/{i}" for i in range(n)]))
        curves[name] = np.round(rng.uniform(0, 1, n) * (2 + seed)) / 4
        gt[name] = (rng.uniform(size=n) < 0.3).astype(np.float32)
    gt["v1"][:] = 0
    del gt["v3"]

    def score_video(frames):
        return {"frame_scores": curves[frames[0].split("/")[0]]}

    got = fa.frame_level_auc(score_video, videos, gt)
    _same_report(got, J.fa.frame_level_auc(score_video, videos, gt), 1e-12)
    assert got["skipped_videos"] == ["v3"]
    assert got["per_video_auc"]["v1"] is None
    assert fa.frame_level_auc(score_video, videos, {})["frame_auc"] is None


def test_roc_auc_matches_sklearn_on_ties(J):
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(4)
    for levels in (1, 2, 3, 10):
        s = rng.integers(0, levels, 200).astype(np.float64)
        y = (rng.uniform(size=200) < 0.4).astype(np.float64)
        assert abs(roc_auc(s, y) - roc_auc_score(y, s)) <= 1e-12


def _stream_frames(frames: list, cfg: DataConfig) -> list:
    """Each frame as `VideoScorer` decodes it: uint8 through the port's
    dataset."""
    one = clip_windows([("v", frames)], 1, 1)
    ds = ClipDataset(one, np.zeros(len(one), np.float32),
                     cfg.replace(clip_len=1, stride=1))
    return [ds.get_uint8(i)[0][0] for i in range(len(one))]


@pytest.mark.parametrize("family", ["d", "b"])
def test_streaming_matches_score_video(request, tree, family):
    _, pfn, _, cfg = request.getfixturevalue(f"family_{family}")
    frames = scan_video_folders(str(Path(tree) / "Test"))[0][1]
    ref = VideoScorer(pfn, cfg).score_video(frames)
    lo, hi = cfg.normalize_clamp

    def clamped(batch):  # the dataset's clamp (family B), as VideoScorer
        return pfn(np.clip(batch, lo, hi) if (lo, hi) != (0.0, 1.0)
                   else batch)

    stream = StreamingScorer(clamped, clip_len=cfg.clip_len,
                             stride=cfg.stride)
    fired = stream.push_many(_stream_frames(frames, cfg))
    assert [w.start for w in fired] == ref["starts"].tolist()
    np.testing.assert_allclose([w.score for w in fired], ref["scores"],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(stream.frame_scores(), ref["frame_scores"],
                               rtol=0, atol=TOL)
    if family == "d":
        assert fired[0].extras[0].shape == (16, 16)
    stream.reset()
    assert stream.n_seen == 0 and stream.windows == []


def test_streaming_through_the_service(tree, family_d):
    """`ClipScoringService.score` as the stream's scorer: its result's
    scores and graphs."""
    _, pfn, _, cfg = family_d
    frames = scan_video_folders(str(Path(tree) / "Test"))[1][1]
    ref = VideoScorer(pfn, cfg).score_video(frames)
    stream = StreamingScorer(ClipScoringService(pfn, buckets=(1, 4)).score,
                             clip_len=8, stride=4)
    fired = stream.push_many(_stream_frames(frames, cfg))
    np.testing.assert_allclose([w.score for w in fired], ref["scores"],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(fired[-1].extras[0], ref["graphs"][-1],
                               rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        stream.push(np.zeros((32, 32, 3), np.float32))


def test_trainer_score_fn(tmp_path, tree):
    """The restored trainer's batch scorer equals the family-D scorer on
    the trainer's weights."""
    from cvad_tpu_torch.train.engine import Trainer

    cfg = preset("family_d")
    cfg = cfg.replace(data=cfg.data.replace(dataset="ucsd_ped2", root=tree))
    trainer = Trainer(cfg, out_dir=str(tmp_path), device="cpu")
    trainer.init_state()
    score = fa.make_trainer_score_fn(trainer)
    clips = np.random.default_rng(0).uniform(
        0, 1, (3, 8, 64, 64, 3)).astype(np.float32)
    want = make_family_d_score_fn(trainer.state.model.state_dict(),
                                  device="cpu")(clips)[0]
    np.testing.assert_allclose(score(clips), want, rtol=0, atol=TOL)
    assert score(clips).shape == (3,)


def test_format_sample_table_matches_jax(J):
    rng = np.random.default_rng(0)
    s, y = rng.uniform(size=60), rng.integers(0, 2, 60)
    for rows in (5, 60, 100):
        assert format_sample_table(s, y, 0.4, rows) == \
            J.metrics.format_sample_table(s, y, 0.4, rows)


def _json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_synth_matches_jax(J, tmp_path, capsys):
    args = ["synth", "--videos", "2", "--frames", "12", "--write-gt",
            "--channels", "3", "--format", "ppm"]
    assert cli.main(args + ["--out", str(tmp_path / "port")]) == 0
    got = _json(capsys)
    assert J.cli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    want = _json(capsys)
    assert sorted(got) == sorted(want)
    assert got["files"] == want["files"] == 2 * 2 * 12 + 2 * 12


def test_cli_score_matches_jax(J, tmp_path, tree, capsys, family_d):
    video_root = str(Path(tree) / "Test")
    common = [video_root, "--checkpoint", CKPT, "--threshold", "0.13",
              "--max-clips", "4"]
    assert cli.main(["score", *common, "--out", str(tmp_path / "p"),
                     "--device", "cpu"]) == 0
    got = _json(capsys)
    with J.jax.default_matmul_precision("highest"):
        assert J.cli.main(["score", *common, "--out",
                             str(tmp_path / "j")]) == 0
    want = _json(capsys)
    assert sorted(got) == sorted(want) == ["anomalous_clips", "max_score"]
    assert got["anomalous_clips"] == want["anomalous_clips"] > 0
    assert abs(got["max_score"] - want["max_score"]) <= TOL
    pj = json.loads((tmp_path / "p" / "anomalous_clips.json").read_text())
    jj = json.loads((tmp_path / "j" / "anomalous_clips.json").read_text())
    assert [(c["video"], c["start"]) for c in pj] == \
        [(c["video"], c["start"]) for c in jj]


def test_cli_auc_matches_jax(J, tmp_path, tree, capsys):
    args = ["auc", "--data-root", tree, "--torch-checkpoint", CKPT]
    assert cli.main(args + ["--device", "cpu", "--report-out",
                            str(tmp_path / "r.json")]) == 0
    got = _json(capsys)
    with J.jax.default_matmul_precision("highest"):
        assert J.cli.main(args) == 0
    want = _json(capsys)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert v is None and got[k] is None or abs(got[k] - v) <= 1e-6
    assert "per_video_auc" in json.loads((tmp_path / "r.json").read_text())


def test_cli_auc_family_b_and_unported(tmp_path, tree, capsys):
    """``auc --family b`` scores against the bank in the checkpoint, as the
    library does; read as family e, its ``.pth`` is refused by the strict
    load (families c, a and e: tests/test_torch_port_family_c.py,
    tests/test_torch_port_train_a.py, tests/test_torch_port_family_e.py)."""
    from cvad_tpu_torch.models import MemoryVideoAutoEncoder
    from cvad_tpu_torch.models.family_b import MemoryBankState

    model = MemoryVideoAutoEncoder(seed=0)
    bank = torch.zeros(500, 64)
    bank[:FILL] = torch.from_numpy(np.random.default_rng(1).normal(
        size=(FILL, 64)).astype(np.float32))
    fill = torch.tensor(FILL, dtype=torch.int32)
    model.set_memory_bank(MemoryBankState(bank, fill, fill))
    path = str(tmp_path / "b.pth")
    torch.save({"model_state_dict": model.state_dict()}, path)
    assert cli.main(["auc", "--preset", "memory_ae", "--data-root", tree,
                     "--torch-checkpoint", path, "--family", "b",
                     "--device", "cpu"]) == 0
    got = _json(capsys)
    want = fa.dataset_frame_auc(make_family_b_score_fn(
        model.state_dict(), device="cpu"), preset("memory_ae").data, tree)
    assert got == {k: want[k] for k in got}
    # every family is ported; a .pth of another family is refused by the
    # strict load
    with pytest.raises(RuntimeError, match="BBoxVizDetector"):
        cli.main(["auc", "--data-root", tree, "--torch-checkpoint",
                  path, "--family", "e", "--device", "cpu"])


def test_cli_train_eval_auc_on_folder_dataset(J, tmp_path, tree, capsys):
    """``train --dataset ucsd_ped2 --data-root`` runs an epoch on the CPU;
    ``eval`` and ``auc --out`` read its checkpoint and print `cvad_tpu`'s
    keys."""
    run = str(tmp_path / "run")
    folder = ["--dataset", "ucsd_ped2", "--data-root", tree]
    assert cli.main(["train", *folder, "--epochs", "1", "--out", run,
                     "--set", "data.batch_size=4", "--device", "cpu"]) == 0
    out = _json(capsys)
    assert out["epochs"] == 1 and np.isfinite(out["final_loss"])
    saved = json.loads((Path(run) / "config.json").read_text())["data"]
    assert (saved["dataset"], saved["root"]) == ("ucsd_ped2", tree)
    assert cli.main(["eval", *folder, "--out", run, "--step", "best",
                     "--device", "cpu"]) == 0
    got = _json(capsys)
    keys = {"checkpoint", "epoch"} | set(J.metrics.family_d_eval_metrics(
        np.zeros(2), np.zeros((2, 16, 16))))
    assert set(got) == keys and got["epoch"] == 1
    assert (Path(run) / "eval_metrics.json").is_file()
    assert cli.main(["eval", *folder, "--out", run, "--step", "7",
                     "--device", "cpu"]) == 1
    assert _json(capsys)["error"] == "no checkpoint found"
    assert cli.main(["auc", "--data-root", tree, "--out", run,
                     "--device", "cpu"]) == 0
    got = _json(capsys)
    assert sorted(got) == ["anomalous_frames", "frame_auc",
                           "frame_auc_normalized", "macro_auc", "n_frames",
                           "n_videos"]
    assert got["n_videos"] == 2 and 0 <= got["frame_auc"] <= 1


def test_cli_entry_points_default_to_cuda(tree):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default is satisfiable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["score", str(Path(tree) / "Test")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["auc", "--data-root", tree, "--torch-checkpoint", CKPT])


def _card_and_cpu(family: str) -> tuple:
    """The port's scorer on the card and on the CPU with the same weights
    (family D: the fixture; family B: the narrow model of the port's own
    seeded init, FILL bank rows), and its data config; skips without a
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if family == "d":
        state, cfg = load_torch_state_dict(CKPT), DataConfig(**CFG_D)
        return (make_family_d_score_fn(state),
                make_family_d_score_fn(state, device="cpu"), cfg)
    from cvad_tpu_torch.models import MemoryVideoAutoEncoder
    from cvad_tpu_torch.models.family_b import MemoryBankState

    mcfg = FamilyBConfig(**NARROW)
    model = MemoryVideoAutoEncoder(mcfg, seed=0)
    bank = torch.zeros(mcfg.memory_size, mcfg.latent_dim)
    bank[:FILL] = torch.from_numpy(np.random.default_rng(3).normal(
        size=(FILL, mcfg.latent_dim)).astype(np.float32))
    fill = torch.tensor(FILL, dtype=torch.int32)
    model.set_memory_bank(MemoryBankState(bank, fill, fill))
    state = model.state_dict()
    return (make_family_b_score_fn(state, cfg=mcfg),
            make_family_b_score_fn(state, cfg=mcfg, device="cpu"),
            preset("memory_ae").data)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["d", "b"])
def test_video_scorer_on_card(tree, family):
    """The port's `VideoScorer` and frame AUC on the card against the port
    on the CPU: windows within 1e-4, the AUC report within 1e-6."""
    card, cpu, cfg = _card_and_cpu(family)
    for _, frames in _videos(tree):
        want = VideoScorer(cpu, cfg).score_video(frames)
        got = VideoScorer(card, cfg).score_video(frames)
        np.testing.assert_array_equal(got["starts"], want["starts"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=1e-4)
    _same_report(fa.dataset_frame_auc(card, cfg, tree),
                 fa.dataset_frame_auc(cpu, cfg, tree), 1e-6)


@pytest.mark.cuda
def test_streaming_on_card(tree):
    """A stream (B=1) on the card against the batched scorer on the card,
    within 1e-5."""
    card, _, cfg = _card_and_cpu("d")
    frames = scan_video_folders(str(Path(tree) / "Test"))[0][1]
    ref = VideoScorer(card, cfg).score_video(frames)
    stream = StreamingScorer(card, clip_len=8, stride=4)
    fired = stream.push_many(_stream_frames(frames, cfg))
    assert [w.start for w in fired] == ref["starts"].tolist()
    np.testing.assert_allclose([w.score for w in fired], ref["scores"],
                               rtol=0, atol=TOL)


def test_scored_clip_record(J):
    from cvad_tpu_torch.evaluation.scoring import ScoredClip

    c = ScoredClip("v", 4, 0.5, ("a", "b"))
    assert dataclasses.asdict(c) == dataclasses.asdict(
        J.sc.ScoredClip("v", 4, 0.5, ("a", "b")))
