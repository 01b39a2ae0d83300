"""Clip-scoring service: the serving path of the port.

Port of `cvad_tpu/evaluation/serving.py` (`ScoreResult`,
`ClipScoringService`, `BatchingServer`):

- requests are padded to a small set of fixed batch-size buckets, so the
  device sees a handful of shapes (cuDNN's per-shape set-up and the first
  kernel launch happen once per bucket, in `warmup`);
- requests larger than the biggest bucket are chunked, empty ones return
  empty;
- a background thread drains a request queue with dynamic batching: it
  coalesces concurrent small requests up to the largest bucket, one device
  batch per dtype.

The ahead-of-time scorer export of `cvad_tpu` is not ported yet (ROADMAP
Queue 1 item 16).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (1, 8, 32, 128)


@dataclass
class ScoreResult:
    scores: np.ndarray
    graphs: Optional[np.ndarray] = None
    # set when the device batch failed: scores is empty and the caller
    # should surface the failure instead of treating it as a result
    error: Optional[str] = None


class ClipScoringService:
    """Batched, bucket-padded scoring over a model forward."""

    def __init__(self, score_fn: Callable[[np.ndarray], Tuple[np.ndarray, ...]],
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 clip_shape: Tuple[int, ...] = (8, 64, 64, 3)):
        self.score_fn = score_fn
        self.buckets = tuple(sorted(buckets))
        self.clip_shape = tuple(clip_shape)  # (T, H, W, C), for warmup
        self._lock = threading.Lock()

    @classmethod
    def from_torch_checkpoint(cls, path: str, family: str = "d", device=None,
                              **kw) -> "ClipScoringService":
        """Serve the family-D model (e.g. the shipped
        ``best_improved_model.pth``, scores and graphs) or the family-B one
        (scores only, against the checkpoint's memory bank) from a
        reference-format ``.pth`` checkpoint."""
        from cvad_tpu_torch.evaluation.scoring import (make_family_b_score_fn,
                                                       make_family_d_score_fn)
        from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

        make = {"d": make_family_d_score_fn, "b": make_family_b_score_fn}
        return cls(make[family](load_torch_state_dict(path), device=device),
                   **kw)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def score(self, clips: np.ndarray) -> ScoreResult:
        """Score (N, T, H, W, C) clips; N may be anything — requests larger
        than the biggest bucket are chunked, empty requests return empty."""
        n = len(clips)
        if n == 0:
            return ScoreResult(scores=np.zeros(0, np.float32))
        big = self.buckets[-1]
        if n > big:
            parts = [self.score(clips[s:s + big]) for s in range(0, n, big)]
            return ScoreResult(
                scores=np.concatenate([p.scores for p in parts]),
                graphs=(np.concatenate([p.graphs for p in parts])
                        if parts[0].graphs is not None else None))
        b = self._bucket(n)
        padded = clips
        if b != n:
            pad = np.repeat(clips[-1:], b - n, axis=0)
            padded = np.concatenate([clips, pad])
        with self._lock:  # one in-flight device call; queue serializes others
            out = self.score_fn(padded)
        if isinstance(out, tuple):
            scores = np.asarray(out[0]).reshape(-1)
            graphs = None if out[1] is None else np.asarray(out[1])[:n]
            return ScoreResult(scores[:n], graphs)
        return ScoreResult(np.asarray(out).reshape(-1)[:n])

    def warmup(self, dtypes: Sequence[str] = ("float32",)) -> None:
        """Run every bucket once per serving dtype, so that the kernel build,
        cuDNN's set-up and the first launches are not paid by live traffic.
        Pass ``("float32", "uint8")`` when clients send raw-pixel uint8
        payloads."""
        for dt in dtypes:
            for b in self.buckets:
                self.score(np.zeros((b,) + self.clip_shape, dt))


@dataclass
class _Pending:
    clips: np.ndarray
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[ScoreResult] = None


class BatchingServer:
    """Dynamic batching front-end: concurrent `submit()` calls coalesce into
    one device batch (up to the largest bucket) drained by a worker thread.
    The kernels launch from that thread, on its current CUDA stream."""

    def __init__(self, service: ClipScoringService,
                 max_wait_ms: float = 2.0):
        self.service = service
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats = {"requests_total": 0, "clips_total": 0,
                       "batches_total": 0, "errors_total": 0,
                       "last_batch_clips": 0, "max_batch_clips": 0,
                       "score_seconds_total": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        """Counters for observability endpoints: coalescing effectiveness is
        ``clips_total / batches_total`` (device batches per request stream)."""
        with self._stats_lock:
            return dict(self._stats)

    def submit(self, clips: np.ndarray, timeout: float = 30.0) -> ScoreResult:
        # uint8 rides through untouched (raw 0-255 pixels, normalized on
        # device); anything else is float clip data in [0, 1]
        arr = np.asarray(clips)
        if arr.dtype != np.uint8:
            arr = np.asarray(arr, np.float32)
        req = _Pending(arr)
        self._q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("scoring request timed out")
        if req.result is None:
            raise RuntimeError("scoring worker set no result")
        return req.result

    def close(self) -> None:
        """Stop the worker after it drains any pending requests."""
        self._stop.set()
        self._worker.join(timeout=5.0)
        # fail anything still enqueued so submitters don't hang
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.result = ScoreResult(scores=np.zeros(0, np.float32),
                                   error="server shutting down")
            p.event.set()

    def _run(self) -> None:
        cap = self.service.buckets[-1]
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return  # drained: safe to exit
                continue
            batch: List[_Pending] = [first]
            total = len(first.clips)
            # coalesce within one absolute window (an arrival stream must not
            # keep extending the first request's latency)
            deadline = time.monotonic() + self.max_wait
            while total < cap:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(nxt)
                total += len(nxt.clips)
            # partition by dtype: concatenating a raw-pixel uint8 request
            # with a normalized float32 one would silently promote the
            # uint8 values into 0-255 floats — wrong by 255x.  Each dtype
            # group is one device batch.
            groups: dict = {}
            for p in batch:
                groups.setdefault(p.clips.dtype.str, []).append(p)
            for grp in groups.values():
                self._score_group(grp)

    def _score_group(self, grp: List[_Pending]) -> None:
        t0 = time.monotonic()
        try:
            # the concatenate sits inside the guard: mixed-shape requests
            # coalesced into one window raise ValueError here, and an escaped
            # exception would kill the worker thread for good
            clips = np.concatenate([p.clips for p in grp])
            res = self.service.score(clips)
        except Exception as e:  # a failed batch must not strand submitters
            n_clips = sum(len(p.clips) for p in grp)
            with self._stats_lock:
                s = self._stats
                s["errors_total"] += 1
                s["requests_total"] += len(grp)
                s["clips_total"] += n_clips
                s["batches_total"] += 1
            for p in grp:
                p.result = ScoreResult(scores=np.zeros(0, np.float32),
                                       error=f"{type(e).__name__}: {e}")
                p.event.set()
            return
        with self._stats_lock:
            s = self._stats
            s["requests_total"] += len(grp)
            s["clips_total"] += len(clips)
            s["batches_total"] += 1
            s["last_batch_clips"] = len(clips)
            s["max_batch_clips"] = max(s["max_batch_clips"], len(clips))
            s["score_seconds_total"] += time.monotonic() - t0
        offset = 0
        for p in grp:
            k = len(p.clips)
            p.result = ScoreResult(
                res.scores[offset:offset + k],
                None if res.graphs is None else res.graphs[offset:offset + k])
            offset += k
            p.event.set()
