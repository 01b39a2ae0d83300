"""Streaming (frame-at-a-time) anomaly scoring for live sources.

Port of `cvad_tpu/evaluation/streaming.py` (`WindowScore`,
`StreamingScorer`).  A camera-style deployment receives frames one at a
time; `StreamingScorer` keeps the T-frame ring buffer, fires the clip
scorer every ``stride`` new frames, and keeps the same per-frame score
curve as the offline `cvad_tpu_torch.evaluation.scoring.VideoScorer`:
window starts, scores and curve equal `score_video`'s for the same frames
(tests/test_torch_port_video.py).

``score_fn`` is any (B, T, H, W, C) -> scores callable: a scorer of
`evaluation/scoring.py` (family D's returns (scores, graphs)) or a
`ClipScoringService.score` (`evaluation/serving.py`), whose result has
``scores`` and ``graphs``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np


@dataclass
class WindowScore:
    """One fired window: frames [start, start+clip_len)."""

    start: int
    score: float
    extras: Optional[tuple] = None  # e.g. the causal graph for family D


class StreamingScorer:
    """Push frames; get a :class:`WindowScore` whenever a window completes.

    Fires on frame indices ``clip_len-1, clip_len-1+stride, …`` — exactly
    the window set ``clip_windows`` generates offline, so a stream replayed
    from a file yields the same scores as ``VideoScorer.score_video``.

    Frames are (H, W, C) float32 in [0, 1] (or uint8, normalized here) and
    must already be at model resolution: decode and resize belong to the
    ingest layer (``data/decode.py``).
    """

    def __init__(self, score_fn: Callable, clip_len: int = 8,
                 stride: int = 4):
        if stride < 1:
            raise ValueError("stride must be >= 1")
        self.score_fn = score_fn
        self.clip_len = int(clip_len)
        self.stride = int(stride)
        self._ring: Optional[np.ndarray] = None  # (clip_len, H, W, C)
        self.n_seen = 0
        self.windows: List[WindowScore] = []

    def push(self, frame: np.ndarray) -> Optional[WindowScore]:
        """Ingest one frame; returns the fired window, if any."""
        f = np.asarray(frame)
        if f.dtype == np.uint8:
            f = f.astype(np.float32) / 255.0
        f = f.astype(np.float32, copy=False)
        if f.ndim == 2:
            f = f[..., None]
        if self._ring is None:
            self._ring = np.zeros((self.clip_len,) + f.shape, np.float32)
        elif f.shape != self._ring.shape[1:]:
            raise ValueError(f"frame shape {f.shape} != stream shape "
                             f"{self._ring.shape[1:]}")
        self._ring[self.n_seen % self.clip_len] = f
        self.n_seen += 1
        if (self.n_seen < self.clip_len
                or (self.n_seen - self.clip_len) % self.stride != 0):
            return None
        # time-ordered view of the ring
        order = (np.arange(self.clip_len) + self.n_seen) % self.clip_len
        clip = self._ring[order][None]  # (1, T, H, W, C)
        out = self.score_fn(clip)
        extras = None
        if isinstance(out, tuple):
            score, extras = out[0], tuple(np.asarray(o)[0] for o in out[1:])
        elif hasattr(out, "scores"):  # a ClipScoringService result
            score, extras = out.scores, (
                None if out.graphs is None else (np.asarray(out.graphs)[0],))
        else:
            score = out
        ws = WindowScore(start=self.n_seen - self.clip_len,
                         score=float(np.asarray(score).reshape(-1)[0]),
                         extras=extras)
        self.windows.append(ws)
        return ws

    def push_many(self, frames) -> List[WindowScore]:
        """Ingest a chunk of frames; returns every window fired."""
        fired = []
        for f in frames:
            ws = self.push(f)
            if ws is not None:
                fired.append(ws)
        return fired

    def frame_scores(self) -> np.ndarray:
        """Per-frame curve over all frames seen so far — mean of covering
        windows, matching ``aggregate_frame_scores`` offline."""
        from cvad_tpu_torch.evaluation.scoring import aggregate_frame_scores

        starts = np.array([w.start for w in self.windows], np.int64)
        scores = np.array([w.score for w in self.windows], np.float32)
        return aggregate_frame_scores(starts, scores, self.clip_len,
                                      self.n_seen)

    def reset(self) -> None:
        """Start a new stream (e.g. scene cut); keeps the compiled fn."""
        self._ring = None
        self.n_seen = 0
        self.windows = []
