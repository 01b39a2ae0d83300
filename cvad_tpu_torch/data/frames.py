"""Frame-folder scanning and clip windowing.

An own copy of `cvad_tpu/data/frames.py` (`ClipSpec`, `FRAME_EXTS`,
`scan_video_folders`, `clip_windows`), standard library only, so that the
port lists the same videos and the same windows in the same order.

Reference semantics being preserved (SURVEY.md §2.1):
- walk ``<root>/<split>/<video_folder>/`` directories of numbered frames
  (``causal_anomaly_detection.py:44-63``);
- exclude ground-truth ``*_gt`` folders (``minicausal_vad_complete3.py:141-143``);
- sliding windows of `clip_len` frames with configurable `stride`
  (reference uses seq_len//2, seq_len//4, or 4 depending on variant);
- optional `max_clips_per_video` subsampling (``minicausal_vad_complete3.py:156-174``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Sequence, Tuple

FRAME_EXTS = (".tif", ".tiff", ".jpg", ".jpeg", ".png", ".bmp", ".pgm", ".ppm", ".npy")


@dataclasses.dataclass(frozen=True)
class ClipSpec:
    """One training/eval clip: a video id, its frame paths, a frame offset."""

    video: str
    frames: Tuple[str, ...]
    start: int
    video_index: int


def scan_video_folders(root: str, exclude_gt: bool = True
                       ) -> List[Tuple[str, List[str]]]:
    """Return [(video_name, sorted frame paths)] for every video folder under
    `root`.  A "video folder" is any directory containing at least one frame
    file; `*_gt` folders are excluded like the reference's ground-truth skip."""
    rootp = Path(root)
    if not rootp.is_dir():
        raise FileNotFoundError(f"dataset root not found: {root}")
    videos = []
    for d in sorted(p for p in rootp.iterdir() if p.is_dir()):
        if exclude_gt and d.name.lower().endswith("_gt"):
            continue
        frames = sorted(
            str(f) for f in d.iterdir()
            if f.suffix.lower() in FRAME_EXTS and not f.name.startswith("."))
        if frames:
            videos.append((d.name, frames))
    if not videos:
        # flat layout: root itself is a single video folder of frames
        frames = sorted(
            str(f) for f in rootp.iterdir()
            if f.suffix.lower() in FRAME_EXTS)
        if frames:
            videos.append((rootp.name, frames))
    return videos


def clip_windows(videos: Sequence[Tuple[str, List[str]]], clip_len: int,
                 stride: int, max_clips_per_video: int = 0
                 ) -> List[ClipSpec]:
    """Slide fixed-length windows over each video's frame list."""
    clips: List[ClipSpec] = []
    for vi, (name, frames) in enumerate(videos):
        starts = list(range(0, max(len(frames) - clip_len + 1, 0), max(stride, 1)))
        if max_clips_per_video and len(starts) > max_clips_per_video:
            # uniform subsample, mirroring the reference's cap semantics
            step = len(starts) / max_clips_per_video
            starts = [starts[int(i * step)] for i in range(max_clips_per_video)]
        for s in starts:
            clips.append(ClipSpec(video=name,
                                  frames=tuple(frames[s:s + clip_len]),
                                  start=s, video_index=vi))
    return clips
