"""The port's localization and reporting path against `cvad_tpu` on the CPU:
the motion detector (its cv2 path and its numpy/scipy path), the detector
ladder (no network: the yolov5 rung loads only from local files),
`annotate_frame` and `score_tier`, `AnomalyVisualizer.create_report`'s
JSON and HTML, ``cli report`` with the family-D fixture, the plots (each
writes its file, and returns None without matplotlib), ``plots
--block-correlation`` fresh and restored, ``diagnose``, ``smoke`` and
``doctor``.

Frames and trees are made from seeds: 2 videos of 24 frames, 64 x 64 RGB
PPM for ``report``.  `cvad_tpu` compiles one JAX function here, family D's
forward inside its ``report``; its detectors and drawing are numpy, scipy
and cv2.  No test reaches the network: `cvad_tpu`'s ladder asks
``torch.hub`` for yolov5 under 'auto', so its side is always given
``motion`` by name.  Tolerances: identical detections, boxes and bytes;
report scores within 1e-5.  The `cuda`-marked test runs ``report`` on
the card against the CPU and skips without a card.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cvad_tpu_torch import cli
from cvad_tpu_torch.evaluation import bbox, detectors, plots
from cvad_tpu_torch.evaluation.scoring import ScoredClip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/dyn_parity_d/ours/best_improved_model.pth")
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def JX():
    """`cvad_tpu`'s reporting modules (flax for its models)."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    from cvad_tpu import cli as jcli
    from cvad_tpu.evaluation import bbox as jbbox
    from cvad_tpu.evaluation import detectors as jdet
    from cvad_tpu.evaluation.scoring import ScoredClip as JScoredClip
    from cvad_tpu.utils import diagnose as jdiag

    return dict(cli=jcli, bbox=jbbox, det=jdet, ScoredClip=JScoredClip,
                diag=jdiag)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A UCSD-style RGB PPM tree: 2 test videos of 24 frames, 64 x 64."""
    root = str(tmp_path_factory.mktemp("report") / "tree")
    assert cli.main(["synth", "--out", root, "--videos", "2", "--frames",
                     "24", "--channels", "3", "--format", "ppm"]) == 0
    return root


def _frames(seed: int = 0, n: int = 4) -> list:
    """Seeded RGB frames (160 x 240) on a flat background: three
    person-shaped bright blocks (w 18-35, h 45-89) a frame, a wide bar and
    a small square."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = np.full((160, 240, 3), rng.integers(10, 40), np.uint8)
        for col in range(3):
            w, h = rng.integers(18, 36), rng.integers(45, 90)
            x, y = col * 70 + rng.integers(5, 70 - w), rng.integers(5, 125 - h)
            f[y:y + h, x:x + w] = rng.integers(200, 256, 3)
        x = rng.integers(5, 180)
        f[135:147, x:x + 50] = 240  # too wide
        f[150:157, 5:12] = 250  # too small
        out.append(f)
    return out


def _boxes(dets) -> list:
    return [(list(map(int, d.bbox)), float(d.confidence)) for d in dets]


@pytest.mark.parametrize("path", ["cv2", "numpy"])
def test_motion_detector_matches_jax(JX, monkeypatch, path):
    """The same boxes as `cvad_tpu`'s on every frame, on its cv2 path and on
    its numpy/scipy path (forced by `_cv2` returning None on both sides);
    some frames have detections."""
    if path == "cv2":
        pytest.importorskip("cv2")
    else:
        monkeypatch.setattr(detectors, "_cv2", lambda: None)
        monkeypatch.setattr(JX["det"], "_cv2", lambda: None)
    found = 0
    for frame in _frames():
        got = _boxes(detectors.detect_persons_motion(frame))
        assert got == _boxes(JX["det"].detect_persons_motion(frame))
        found += len(got)
    assert found > 0


@pytest.mark.parametrize("path", ["cv2", "numpy"])
def test_annotate_frame_byte_identical(JX, monkeypatch, path):
    """Each tier's drawing equals `cvad_tpu`'s byte for byte, boxes at the
    edges and past them included; the numpy path is forced by making
    ``import cv2`` fail on both sides."""
    if path == "cv2":
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    frame = _frames(seed=1, n=1)[0]
    dets = [detectors.Detection([10, 40, 30, 100], 0.5),
            detectors.Detection([0, 0, 20, 50], 0.91),
            detectors.Detection([140, 90, 170, 130], 0.25)]
    jdets = [JX["det"].Detection(list(d.bbox), d.confidence) for d in dets]
    for score in (0.1, 0.3, 0.35, 0.4, 0.7):
        got = bbox.annotate_frame(frame, dets, score)
        want = JX["bbox"].annotate_frame(frame, jdets, score)
        assert got.dtype == np.uint8 and np.array_equal(got, want), score
        assert not np.array_equal(got, frame)
    assert np.array_equal(frame, _frames(seed=1, n=1)[0])  # not drawn on


def test_score_tier_edges(JX):
    """The tiers' edges (> 0.3 suspicious, > 0.4 anomaly) as `cvad_tpu`'s."""
    for s in (0.0, 0.3, np.nextafter(0.3, 1), 0.35, 0.4,
              np.nextafter(0.4, 1), 1.0):
        assert bbox.score_tier(s) == JX["bbox"].score_tier(s)
    assert [bbox.score_tier(s) for s in (0.3, 0.30001, 0.4, 0.40001)] == [
        "normal", "suspicious", "suspicious", "anomaly"]


def test_detector_ladder_reaches_no_network(monkeypatch, tmp_path):
    """'auto' resolves to the motion detector without calling
    ``torch.hub.load`` or ``urlopen``; 'yolov5' and 'opencv' by name raise
    without their files; with a local hub checkout and weights the yolov5
    rung loads them by path, ``source='local'``."""
    import urllib.request

    def no_network(*a, **k):
        raise AssertionError("a network call was made")

    monkeypatch.setattr(torch.hub, "load", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    for weights_dir in (None, str(tmp_path)):
        fn, name = detectors.setup_detector("auto", weights_dir)
        assert (fn, name) == (detectors.detect_persons_motion, "motion")
        with pytest.raises(RuntimeError, match="yolov5"):
            detectors.setup_detector("yolov5", weights_dir)
        with pytest.raises(RuntimeError, match="opencv"):
            detectors.setup_detector("opencv", weights_dir)
    assert detectors.get_detector("auto") is detectors.detect_persons_motion
    assert bbox.AnomalyVisualizer(None).detector_backend == "motion"
    with pytest.raises(KeyError):
        detectors.get_detector("nope")

    (tmp_path / "yolov5").mkdir()
    (tmp_path / "yolov5" / "hubconf.py").write_text("")
    (tmp_path / "yolov5s.pt").write_bytes(b"")
    calls = []

    class Result:
        xyxy = [torch.tensor([[1.0, 2.0, 30.0, 80.0, 0.9, 0.0],
                              [5.0, 5.0, 9.0, 9.0, 0.9, 2.0]])]

    def local_load(repo, entry, **kw):
        calls.append((repo, entry, kw))
        return lambda frame: Result()

    monkeypatch.setattr(torch.hub, "load", local_load)
    fn, name = detectors.setup_detector("auto", str(tmp_path))
    assert name == "yolov5" and calls == [(
        str(tmp_path / "yolov5"), "custom",
        {"path": str(tmp_path / "yolov5s.pt"), "source": "local",
         "verbose": False})]
    assert _boxes(fn(None)) == [([1, 2, 30, 80], pytest.approx(0.9))]


def _clips(tree, cls, graph: bool):
    """A scored clip of the tree's first video: with a causal graph (tier
    anomaly) or without one (tier suspicious)."""
    from cvad_tpu_torch.data.frames import scan_video_folders

    name, frames = scan_video_folders(str(Path(tree) / "Test"))[0]
    if graph:
        # about 1 entry in 9 above 0.5, each of which the heatmap labels
        g = np.random.default_rng(2).uniform(0, 1, (16, 16)) ** 6
        return [cls(name, 4, 0.45, tuple(frames[4:12]),
                    g.astype(np.float32))]
    return [cls(name, 12, 0.35, tuple(frames[12:20]), None)]


@pytest.mark.parametrize("graph", [True, False])
def test_create_report_matches_jax(JX, tree, tmp_path, monkeypatch, graph):
    """`create_report` on the same clip, backend 'motion': the aggregate
    JSON, the clip's ``_info.json`` and the HTML equal `cvad_tpu`'s, and
    the files it lists exist.  With a causal graph matplotlib draws it and
    the grid; the clip without one runs with matplotlib blocked on both
    sides (no PNG: where a graph is given, `cvad_tpu` lists the heatmap it
    could not draw, the port does not)."""
    if graph:
        pytest.importorskip("matplotlib")
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = bbox.AnomalyVisualizer(None, "motion").create_report(
        _clips(tree, ScoredClip, graph), tmp_path / "port")
    want = JX["bbox"].AnomalyVisualizer(None, "motion").create_report(
        _clips(tree, JX["ScoredClip"], graph), str(tmp_path / "jax"))
    assert got == want
    for name in ("anomaly_detection_report.json",
                 "anomaly_detection_report.html"):
        assert (tmp_path / "port" / name).read_text() == (
            tmp_path / "jax" / name).read_text()
    (clip,) = got["clips"]
    d = tmp_path / "port" / clip["clip_id"]
    (info,) = d.glob("*_info.json")
    assert info.read_text() == (tmp_path / "jax" / clip["clip_id"]
                                / info.name).read_text()
    for f in clip["files"].values():
        assert f is None or (d / f).stat().st_size > 0
    pngs = [clip["files"][k] for k in ("grid_image", "causal_graph")]
    assert all(pngs) if graph else pngs == [None, None]


def _report(main, tree, out, *extra):
    return main(["report", str(Path(tree) / "Test"), "--checkpoint", CKPT,
                 "--threshold", "0.1", "--max-clips", "3", "--detector",
                 "motion", "--out", str(out), *extra])


def _same_reports(a: Path, b: Path, backend: str = "motion") -> dict:
    """Two report directories hold the same clips (ids, videos, frame
    ranges, the video distribution, the backend), scores within
    SCORE_TOL; each clip's ``_info.json`` the same way."""
    ra = json.loads((a / "anomaly_detection_report.json").read_text())
    rb = json.loads((b / "anomaly_detection_report.json").read_text())
    assert ra["detection_backend"] == rb["detection_backend"] == backend
    assert ra["video_distribution"] == rb["video_distribution"]
    assert ra["total_clips_analyzed"] == rb["total_clips_analyzed"] > 0
    for ca, cb in zip(ra["clips"], rb["clips"], strict=True):
        assert (ca["clip_id"], ca["video_id"], ca["frame_range"]) == (
            cb["clip_id"], cb["video_id"], cb["frame_range"])
        assert abs(ca["anomaly_score"] - cb["anomaly_score"]) <= SCORE_TOL
        ia, ib = ([json.loads(p.read_text())
                   for p in (d / ca["clip_id"]).glob("*_info.json")]
                  for d in (a, b))
        assert len(ia) == len(ib) == 1
        ia, ib = ia[0], ib[0]
        assert abs(ia.pop("anomaly_score") - ib.pop("anomaly_score")) \
            <= SCORE_TOL
        assert ia == ib
    assert (a / "anomaly_detection_report.html").is_file()
    return ra


def test_cli_report_matches_jax(JX, tree, tmp_path, capsys, monkeypatch):
    """``report`` with the fixture (family D) against `cvad_tpu`'s
    ``report`` on the same tree: the same clips, scores within SCORE_TOL.
    matplotlib is blocked on both sides here (the figures are
    `test_create_report_matches_jax`'s): the JSON, the HTML and the
    annotated frames do not need it."""
    import jax

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert _report(cli.main, tree, tmp_path / "port", "--device", "cpu") == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with jax.default_matmul_precision("highest"):
        assert _report(JX["cli"].main, tree, tmp_path / "jax") == 0
    capsys.readouterr()
    rep = _same_reports(tmp_path / "port", tmp_path / "jax")
    assert got == {"clips": rep["total_clips_analyzed"],
                   "report": str(tmp_path / "port"
                                 / "anomaly_detection_report.html")}
    html = (tmp_path / "port" / "anomaly_detection_report.html").read_text()
    assert all(c["clip_id"] in html for c in rep["clips"])
    assert not list((tmp_path / "port").rglob("*.png"))


@pytest.fixture(scope="module")
def run_c(tmp_path_factory):
    """A family-C run of the port: 2 epochs on 16 x 16 synthetic clips."""
    run = str(tmp_path_factory.mktemp("run_c"))
    assert cli.main(["train", "--preset", "mini3d", "--epochs", "2",
                     "--n-synthetic", "8", "--set", "data.frame_size=16,16",
                     "--device", "cpu", "--out", run]) == 0
    return run


def test_plots_write_files_and_need_matplotlib(tmp_path, monkeypatch):
    """Each dashboard writes its PNG and returns its path; with matplotlib
    blocked each returns None (and the bbox writers False)."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(3)
    n = 10  # t-SNE and the factor-score panel take more than 10 samples
    labels = (np.arange(n) % 3 == 0).astype(np.float32)
    preds = rng.uniform(0, 1, n).astype(np.float32)
    outputs = {"predictions": preds, "labels": labels,
               "causal_graphs": rng.uniform(0, 1, (n, 6, 6)),
               "factors": rng.normal(size=(n, 6)),
               "kl_losses": rng.uniform(0, 1, n),
               "detection_counts": rng.integers(0, 5, n)}
    history = {"epochs": [1, 2], "train_losses": [1.0, 0.5],
               "loss_components": [{"anomaly_loss": 1.0, "loss": 1.0}] * 2,
               "evaluation_metrics": [{"mean_score": 0.3, "score_range": 0.2,
                                       "avg_sparsity": 0.1}] * 2}
    frames = rng.uniform(0, 1, (3, 24, 32, 1))
    boxes = np.tile(np.array([[10.0, 10.0, 6.0, 8.0]]), (3, 2, 1))
    mask = np.array([[True, False]] * 3)
    dpi = 40  # the figures' size, not their content, sets the time
    calls = {
        "results": lambda p: plots.visualize_results(
            preds, labels, outputs["factors"], p, dpi=dpi),
        "analysis": lambda p: plots.create_additional_analysis(outputs, p,
                                                               dpi=dpi),
        "training": lambda p: plots.visualize_training_results(history, p,
                                                               dpi=dpi),
        "boxes": lambda p: plots.visualize_bounding_boxes(
            frames, boxes, mask, p, scores=np.array([0.4]), dpi=dpi),
    }
    for name, fn in calls.items():
        path = str(tmp_path / f"{name}.png")
        assert fn(path) == path and Path(path).stat().st_size > 0, name
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for name, fn in calls.items():
        assert fn(str(tmp_path / f"none_{name}.png")) is None, name
    assert not list(tmp_path.glob("none_*"))
    from cvad_tpu_torch.evaluation.block_correlation import \
        plot_block_correlations

    assert plot_block_correlations([np.eye(2)], str(tmp_path / "b.png")) \
        is None
    assert bbox.plot_causal_graph(np.eye(16), str(tmp_path / "g.png")) \
        is False


def test_cli_plots_diagnose_on_a_port_run(JX, run_c, tmp_path, capsys,
                                          monkeypatch):
    """A port run's history draws (its keys are the ones the dashboard
    reads) and diagnoses as `cvad_tpu` diagnoses it; ``plots
    --block-correlation`` draws the restored run's and a fresh init's
    blocks (8, 16, 32 channels)."""
    pytest.importorskip("matplotlib")
    hist = str(Path(run_c) / "improved_training_history.json")
    keys = set(json.loads(Path(hist).read_text()))
    assert {"epochs", "train_losses", "loss_components",
            "evaluation_metrics"} <= keys
    png = str(tmp_path / "dash.png")
    assert cli.main(["plots", hist, "--out", png]) == 0
    assert capsys.readouterr().out.strip() == png
    assert Path(png).stat().st_size > 0
    assert cli.main(["diagnose", hist]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JX["cli"].main(["diagnose", hist]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    for run in (["--run", run_c, "--step", "best"], []):
        out = str(tmp_path / f"blocks{len(run)}.png")
        assert cli.main(["plots", "--block-correlation", *run, "--out", out,
                         "--set", "data.frame_size=16,16",
                         "--device", "cpu"]) == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["out"] == out and Path(out).stat().st_size > 0
        assert rep["blocks"] == [8, 16, 32]
        assert rep["restored"] == (2 if run else None)
    assert cli.main(["plots", "--block-correlation", "--run",
                     str(tmp_path / "empty"), "--device", "cpu",
                     "--set", "data.frame_size=16,16"]) == 1
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert cli.main(["plots", hist, "--out", str(tmp_path / "x.png")]) == 1
    assert cli.main(["plots", str(tmp_path / "missing.json")]) == 1


def test_diagnose_matches_jax(JX):
    """`diagnose_training_issues` on histories that raise every warning
    and on a healthy one: `cvad_tpu`'s findings."""
    from cvad_tpu_torch.utils.diagnose import diagnose_training_issues

    flat = {"train_losses": [1.0] * 12,
            "loss_components": [{"sparsity_loss": 9.0, "anomaly_loss": 1.0,
                                 "acyclicity_loss": 0.0}],
            "evaluation_metrics": [{"score_range": 0.0, "mean_score": 0.0}]
            * 3}
    cyclic = {"loss_components": [{"acyclicity_loss": 95.0, "x_loss": 5.0}]}
    healthy = {"train_losses": list(np.linspace(2.0, 0.5, 12)),
               "evaluation_metrics": [{"score_range": 0.3,
                                       "mean_score": 0.2}]}
    for h in (flat, cyclic, healthy, {}):
        got = diagnose_training_issues(h, verbose=False)
        assert got == JX["diag"].diagnose_training_issues(h, verbose=False)
    assert len(diagnose_training_issues(flat, verbose=False)["warnings"]) \
        == 4
    assert diagnose_training_issues(history_file="/nonexistent.json",
                                    verbose=False)["warnings"] == [
        "history unreadable"]


def test_smoke_and_dataset_audit_match_jax(JX, tree, capsys):
    """``smoke`` passes on the CPU with `cvad_tpu`'s result keys and
    verdicts (family C fresh: scores near 0.5, shape (2, 1)); the dataset
    audit gives `cvad_tpu`'s records on the same tree."""
    from cvad_tpu.config import DataConfig as JDataConfig
    from cvad_tpu.data.datasets import build_dataset as jbuild

    from cvad_tpu_torch.config import DataConfig
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.utils.diagnose import debug_dataset_dtypes

    assert cli.main(["smoke", "--data-root", tree, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["ok"] and got["param_dtype_issues"] == []
    assert got["output_shape"] == [2, 1] and got["device"] == "cpu"
    assert not got["has_nan"] and not got["has_inf"]
    lo, hi = got["output_range"]
    assert 0.49 < lo <= hi < 0.51
    recs = got["dataset_samples"]
    assert len(recs) == 3 and not any(r["float64"] for r in recs)
    cfg = dict(dataset="ucsd_ped2", root=tree)
    port = debug_dataset_dtypes(build_dataset(DataConfig(**cfg)),
                                verbose=False)
    jax_recs = JX["diag"].debug_dataset_dtypes(jbuild(JDataConfig(**cfg)),
                                               verbose=False)
    assert port == jax_recs
    assert [dict(r, shape=list(r["shape"])) for r in port] == recs


def test_cli_doctor_without_a_card(capsys):
    """``doctor`` reports the native decoder and the optional modules and
    exits 1 here: the child process sees no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert cli.main(["doctor", "--probe-timeout", "120"]) == 1
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["device_probe"] == "error"
    assert "no CUDA device" in info["device_probe_detail"]
    assert info["native_decoder"] and ".ppm" in info["native_formats"]
    assert {"has_pil", "has_cv2", "has_matplotlib", "has_sklearn",
            "has_scipy", "nvcc"} <= set(info)


@pytest.mark.cuda
def test_report_on_card_launches_k1(tree, tmp_path, capsys):
    """``report`` on the card against the CPU: the same clips, scores
    within SCORE_TOL; K1 launched once a scored batch (2 videos: 2
    batches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1

    assert _report(cli.main, tree, tmp_path / "cpu", "--device", "cpu") == 0
    tfold_conv1.launches = 0
    assert _report(cli.main, tree, tmp_path / "card") == 0
    assert tfold_conv1.launches == 2
    capsys.readouterr()
    _same_reports(tmp_path / "card", tmp_path / "cpu")
