"""Bbox-localized anomaly visualization and reporting.

Port of `cvad_tpu/evaluation/bbox.py` (the reference's `AnomalyVisualizer`,
``avenue_training_script_bbox.py:103-660``): score-tiered boxes (> 0.4
red "ANOMALY", 0.3-0.4 yellow "SUSPICIOUS", else green "NORMAL",
``:470-491``) drawn on each frame of an anomalous clip, a 2x4 frame grid,
an MP4 (``:548-566``), the 16x16 causal-graph heatmap (``:568-600``), the
per-clip JSON (``:527-537``), the aggregate JSON report (``:602-652``) and
the HTML report that the reference calls but never defines (``:655``).

Scoring is the `VideoScorer`'s (the card); decoding, detection, drawing
and writing run on the host.  Drawing has a cv2 path and a numpy path.
Without matplotlib no PNG is written and without cv2 no MP4 (each writer
returns False); the annotated frames, the JSON and the HTML reports are
complete either way.  The report records the detector that ran (the
ladder's pick for 'auto'), where `cvad_tpu` records the name asked for.
"""

from __future__ import annotations

import ctypes
import html
from pathlib import Path
from typing import Dict, List

import numpy as np

from cvad_tpu_torch.evaluation.detectors import (Detection, _cv2,
                                                 get_detector,
                                                 setup_detector)
from cvad_tpu_torch.evaluation.plots import _plt
from cvad_tpu_torch.evaluation.scoring import ScoredClip, VideoScorer
from cvad_tpu_torch.utils.json_utils import safe_json_save

COLORS = {  # RGB, the reference's tiers
    "anomaly": (255, 0, 0),
    "suspicious": (255, 255, 0),
    "normal": (0, 255, 0),
}
LABELS = {"anomaly": "ANOMALY", "suspicious": "SUSPICIOUS",
          "normal": "NORMAL"}


def score_tier(score: float) -> str:
    if score > 0.4:
        return "anomaly"
    if score > 0.3:
        return "suspicious"
    return "normal"


def _load_rgb(path: str) -> np.ndarray:
    """One frame at its own size as (H, W, 3) uint8, through the port's
    decoder."""
    from cvad_tpu_torch.data.decode import decode_frame

    arr = decode_frame(path, _probe_size(path), grayscale=False)
    return (arr * 255).astype(np.uint8)


def _probe_size(path: str):
    """A frame's own (H, W): the native decoder's header probe for PNM and
    BMP, else PIL, else (240, 360)."""
    from cvad_tpu_torch.data.native_decoder import load_library

    lib = load_library()
    if lib is not None and path.lower().endswith((".pgm", ".ppm", ".bmp")):
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.cvad_probe(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c)) == 0:
            return (h.value, w.value)
    try:
        from PIL import Image

        with Image.open(path) as im:
            return (im.height, im.width)
    except (ImportError, OSError):
        return (240, 360)


def annotate_frame(frame: np.ndarray, detections: List[Detection],
                   clip_score: float) -> np.ndarray:
    """A copy of `frame` with each detection's box in the clip's tier
    color: cv2 boxes with a filled label where cv2 is present, else 2-pixel
    numpy rectangles."""
    out = frame.copy()
    tier = score_tier(clip_score)
    color = np.array(COLORS[tier], np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        for det in detections:
            x1, y1, x2, y2 = det.bbox
            cv2.rectangle(out, (x1, y1), (x2, y2), color.tolist(), 2)
            text = f"{LABELS[tier]}: {det.confidence:.2f}"
            sz = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 2)[0]
            cv2.rectangle(out, (x1, max(y1 - sz[1] - 10, 0)),
                          (x1 + sz[0], y1), color.tolist(), -1)
            cv2.putText(out, text, (x1, max(y1 - 5, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 2)
        return out
    h, w = out.shape[:2]
    for det in detections:
        x1, y1, x2, y2 = [int(np.clip(v, 0, m - 1)) for v, m in
                          zip(det.bbox, (w, h, w, h))]
        out[y1:y2 + 1, x1:x1 + 2] = color
        out[y1:y2 + 1, max(x2 - 1, 0):x2 + 1] = color
        out[y1:y1 + 2, x1:x2 + 1] = color
        out[max(y2 - 1, 0):y2 + 1, x1:x2 + 1] = color
    return out


def write_mp4(frames: List[np.ndarray], path: str, fps: int = 2) -> bool:
    """MP4 of RGB frames (reference ``create_video_from_frames``
    ``:548-566``); False without frames or cv2."""
    cv2 = _cv2()
    if not frames or cv2 is None:
        return False
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    if not writer.isOpened():
        return False
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return True


def plot_causal_graph(graph: np.ndarray, path: str) -> bool:
    """16x16 adjacency heatmap (reference ``:568-600``); False without
    matplotlib."""
    plt = _plt()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(12, 10))
    im = ax.imshow(graph, cmap="Reds", vmin=0, vmax=1)
    plt.colorbar(im, ax=ax).set_label("Causal Strength", rotation=270,
                                      labelpad=20)
    ax.set_xlabel("Target Variables")
    ax.set_ylabel("Source Variables")
    ax.set_title("Learned Causal Graph\n(Red = Strong Causal Relationship)")
    n = graph.shape[0]
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.grid(True, alpha=0.3)
    for i, j in zip(*np.where(graph > 0.5)):
        ax.text(j, i, f"{graph[i, j]:.2f}", ha="center", va="center",
                color="white", fontweight="bold")
    fig.tight_layout()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return True


def clip_id(clip: ScoredClip) -> str:
    end = clip.start + len(clip.frames) - 1
    return f"video_{clip.video}_frames_{clip.start}_{end}"


class AnomalyVisualizer:
    """Localize, annotate and report the anomalous clips a `VideoScorer`
    found."""

    def __init__(self, scorer: VideoScorer, detector_backend: str = "auto"):
        self.scorer = scorer
        if detector_backend in ("auto", "yolov5", "opencv"):  # the ladder
            self.detector, self.detector_backend = setup_detector(
                detector_backend)
        else:
            self.detector = get_detector(detector_backend)
            self.detector_backend = detector_backend

    def annotated_frames(self, clip: ScoredClip):
        """Each frame of `clip` decoded, its detections and its annotated
        copy: (frames, person counts)."""
        annotated: List[np.ndarray] = []
        person_counts: List[int] = []
        for fp in clip.frames:
            frame = _load_rgb(fp)
            persons = self.detector(frame)
            person_counts.append(len(persons))
            annotated.append(annotate_frame(frame, persons, clip.score))
        return annotated, person_counts

    def visualize_clip(self, clip: ScoredClip, output_dir) -> Dict:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cid = clip_id(clip)
        annotated, person_counts = self.annotated_frames(clip)

        grid_path = out / f"{cid}_grid.png"
        have_grid = self._plot_grid(annotated, person_counts, clip, grid_path)
        video_path = out / f"{cid}_annotated.mp4"
        have_video = write_mp4(annotated, str(video_path))
        graph_path = None
        if clip.causal_graph is not None:
            graph_path = out / f"{cid}_causal_graph.png"
            if not plot_causal_graph(np.asarray(clip.causal_graph),
                                     str(graph_path)):
                graph_path = None

        info_path = out / f"{cid}_info.json"
        safe_json_save({
            "clip_id": cid,
            "anomaly_score": clip.score,
            "video_id": clip.video,
            "frame_range": [clip.start, clip.start + len(clip.frames) - 1],
            "detection_backend": self.detector_backend,
        }, info_path, verbose=False)
        return {
            "clip_id": cid,
            "grid_image": grid_path if have_grid else None,
            "annotated_video": video_path if have_video else None,
            "causal_graph": graph_path,
            "info_file": info_path,
        }

    def _plot_grid(self, frames: List[np.ndarray], person_counts: List[int],
                   clip: ScoredClip, path: Path) -> bool:
        """2x4 annotated-frame grid (reference ``:443-515``); False without
        matplotlib."""
        plt = _plt()
        if plt is None:
            return False
        fig, axes = plt.subplots(2, 4, figsize=(20, 10))
        fig.suptitle(
            f"Anomalous Clip: video {clip.video} frames "
            f"{clip.start}-{clip.start + len(clip.frames) - 1}\n"
            f"Anomaly Score: {clip.score:.3f}",
            fontsize=16, fontweight="bold")
        for i in range(8):
            ax = axes[divmod(i, 4)]
            if i < len(frames):
                ax.imshow(frames[i])
                ax.set_title(f"Frame {clip.start + i}\n"
                             f"Persons: {person_counts[i]}")
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return True

    def create_report(self, clips: List[ScoredClip], output_dir) -> Dict:
        """Every clip visualized under ``clip_NNN/``, then the aggregate
        ``anomaly_detection_report.json`` and ``.html``; returns the
        summary."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        results = [self.visualize_clip(c, out / f"clip_{i + 1:03d}")
                   for i, c in enumerate(clips)]

        video_distribution: Dict[str, int] = {}
        for c in clips:
            video_distribution[c.video] = video_distribution.get(c.video, 0) + 1
        summary = {
            "total_clips_analyzed": len(clips),
            "detection_backend": self.detector_backend,
            "anomaly_scores": [c.score for c in clips],
            "video_distribution": video_distribution,
            "clips": [{
                "clip_id": f"clip_{i + 1:03d}",
                "anomaly_score": c.score,
                "video_id": c.video,
                "frame_range": [c.start, c.start + len(c.frames) - 1],
                "files": {
                    key: r[key].name if r[key] else None
                    for key in ("grid_image", "annotated_video",
                                "causal_graph")},
            } for i, (c, r) in enumerate(zip(clips, results))],
        }
        safe_json_save(summary, out / "anomaly_detection_report.json",
                       verbose=False)
        self.create_html_report(summary, out)
        return summary

    def create_html_report(self, summary: Dict, output_dir) -> Path:
        """A standalone page with a row a clip (tier-colored) linking the
        clip's files (the reference promises it at ``:655``)."""
        rows = []
        for clip in summary["clips"]:
            links = " | ".join(
                f'<a href="{html.escape(clip["clip_id"])}/{html.escape(v)}">{k}</a>'
                for k, v in clip["files"].items() if v)
            tier = score_tier(clip["anomaly_score"])
            rows.append(
                f'<tr class="{tier}"><td>{html.escape(clip["clip_id"])}</td>'
                f'<td>{html.escape(str(clip["video_id"]))}</td>'
                f'<td>{clip["frame_range"][0]}-{clip["frame_range"][1]}</td>'
                f'<td>{clip["anomaly_score"]:.3f}</td><td>{links}</td></tr>')
        doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>Anomaly Detection Report</title>
<style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; width: 100%; }}
td, th {{ border: 1px solid #ccc; padding: 6px 10px; text-align: left; }}
tr.anomaly td {{ background: #ffe5e5; }}
tr.suspicious td {{ background: #fff8dc; }}
tr.normal td {{ background: #eaffea; }}
</style></head><body>
<h1>Anomaly Detection Report</h1>
<p>Clips analyzed: {summary["total_clips_analyzed"]} ·
Detection backend: {html.escape(str(summary["detection_backend"]))}</p>
<table><tr><th>Clip</th><th>Video</th><th>Frames</th><th>Score</th>
<th>Artifacts</th></tr>
{''.join(rows)}
</table></body></html>
"""
        path = Path(output_dir) / "anomaly_detection_report.html"
        path.write_text(doc)
        return path
