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

- ahead-of-time export (`cvad_tpu`'s ``jax.export`` blobs, :244-399):
  `export_scorer` (family D) and `export_family_{b,a,e,c}_scorer` trace a
  family's scorer with `torch.export` over float32 (N, T, H, W, C) clips,
  the batch a dynamic dimension (min 1), and return the bytes of a
  `torch.export.save` archive; `load_scorer` runs such bytes with no model
  code (the kernels' custom ops come with `cvad_tpu_torch.ops`), and
  `ClipScoringService.from_exported` serves them.  An artefact runs on the
  device it was exported on (CUDA unless the caller asks for the CPU, the
  counterpart of ``platforms``): the routes that pick a kernel by device
  are fixed when it is traced, so a CUDA artefact launches K1, K3, K5 and
  K6 where the model does, and a CPU one runs their plain versions.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import zipfile
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

import cvad_tpu_torch.ops  # noqa: F401  (registers the kernels' custom ops)
from cvad_tpu_torch.config import LossConfig
from cvad_tpu_torch.runtime.device import no_tf32, resolve_device

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

    @classmethod
    def from_exported(cls, blob: bytes, **kw) -> "ClipScoringService":
        """Serve an exported scorer (`export_scorer` and the family
        exporters) with no model code, at the artefact's own clip shape
        unless `clip_shape` is given."""
        fn = load_scorer(blob)
        kw.setdefault("clip_shape", fn.clip_shape)
        return cls(fn, **kw)

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


# ---------------------------------------------------------------------------
# Ahead-of-time export (deployment artefacts)
# ---------------------------------------------------------------------------

# the artefact's own record, an extra file of the archive
ARTEFACT_META = "cvad_scorer.json"
_EXAMPLE_BATCH = 2  # the traced batch; the artefact takes any batch >= 1


class ScorerModule(nn.Module):
    """A family's scorer as one module over float32 (N, T, H, W, C) clips
    in [0, 1]: the layout permute, the eval forward and `cvad_tpu`'s
    exported outputs (D and E (scores, adjacency); B ``b_score_recon`` x
    recon MSE + ``b_score_memory`` x memory distance against the model's
    bank; A (scores, detections, detection_mask); C scores).  It is the
    one definition of each family's scorer: the eager scorers of
    `evaluation.scoring` call it, and the exporters trace it."""

    def __init__(self, family: str, model: nn.Module, loss_cfg=None):
        super().__init__()
        self.family = family
        self.model = model.eval()
        if family == "b":
            w = loss_cfg or LossConfig()
            self.weights = (w.b_score_recon, w.b_score_memory)

    def forward(self, clips: torch.Tensor):
        if self.family in ("a", "b"):  # frames (N, T, C, H, W)
            x = clips.permute(0, 1, 4, 2, 3).contiguous()
        else:  # (N, C, T, H, W)
            x = clips.permute(0, 4, 1, 2, 3).contiguous()
        if self.family in ("d", "e"):
            scores, adj, _ = self.model(x)
            return scores.reshape(-1), adj
        if self.family == "c":
            return self.model(x).reshape(-1)
        out = self.model(x)
        if self.family == "a":
            return (out["anomaly_scores"].reshape(-1), out["detections"],
                    out["detection_mask"])
        recon = ((out["reconstructed"] - x) ** 2).mean((1, 2, 3, 4))
        return (self.weights[0] * recon
                + self.weights[1] * out["anomaly_score"])


def scorer_module(family: str, state, cfg=None, memory=None, loss_cfg=None,
                  device=None) -> ScorerModule:
    """The `ScorerModule` of `family` with the weights of `state` (the
    reference ``.pth`` keys, loaded strictly), built by
    `models.registry.build_model` from `cfg` (the family's default config
    when None), in ``eval()`` on `device` (CUDA unless the caller asks for
    the CPU).  Family B's `memory`, a `MemoryBankState`, replaces the bank
    that `state` holds; family A's input channels come from its conv1."""
    from cvad_tpu_torch.config import FAMILY_CONFIGS
    from cvad_tpu_torch.models.family_b import MemoryBankState
    from cvad_tpu_torch.models.registry import build_model

    dev = resolve_device(device)
    cfg = cfg if cfg is not None else FAMILY_CONFIGS[family]()
    kw = ({"in_channels": state["backbone.conv1.weight"].shape[1]}
          if family == "a" else {})
    model = build_model(cfg, **kw)
    model.load_state_dict(state, strict=True)
    model = model.to(dev)
    if memory is not None:
        model.set_memory_bank(MemoryBankState(*(
            torch.as_tensor(np.asarray(v)).to(dev) for v in memory)))
    return ScorerModule(family, model, loss_cfg)


def export_scorer(state, clip_shape=(8, 64, 64, 3), cfg=None, *,
                  device=None) -> bytes:
    """Family D's scorer (the flagship, (scores, adjacency)) as the bytes
    of a `torch.export` archive over float32 (N,) + `clip_shape` clips,
    the batch dynamic.  `cfg` is the `FamilyDConfig` (its conv1 knobs
    decide K1 or K5 at long T); `device` is where the artefact runs."""
    return _export_fwd(scorer_module("d", state, cfg, device=device),
                       clip_shape)


def export_family_b_scorer(state, memory=None, clip_shape=(8, 64, 64, 1),
                           loss_cfg=None, cfg=None, *, device=None) -> bytes:
    """Family B's combined scorer (0.7 recon MSE + 0.3 memory distance,
    ``causal_anomaly_detection1.py:552``) as an artefact, the bank (that of
    `state`, or `memory`) baked in: scoring-time memory is frozen in the
    reference too.  `cfg` selects the LSTM or the attention encoder
    (K6 on the card at T a multiple of 128 and head dim 128)."""
    return _export_fwd(scorer_module("b", state, cfg, memory, loss_cfg,
                                     device), clip_shape)


def export_family_a_scorer(state, clip_shape=(16, 240, 360, 1), cfg=None, *,
                           device=None) -> bytes:
    """Family A's causal-pipeline scorer as an artefact: the deterministic
    eval forward's blended scores, detections and their validity mask.
    The default `clip_shape` is the reference's 16-frame 240x360 gray
    clip."""
    return _export_fwd(scorer_module("a", state, cfg, device=device),
                       clip_shape)


def export_family_e_scorer(state, clip_shape=(8, 64, 64, 3), cfg=None, *,
                           device=None) -> bytes:
    """Family E's (bbox-viz stand-in) scorer as an artefact: (scores,
    adjacency) like family D's."""
    return _export_fwd(scorer_module("e", state, cfg, device=device),
                       clip_shape)


def export_family_c_scorer(state, clip_shape=(8, 64, 64, 1), cfg=None, *,
                           device=None) -> bytes:
    """Family C's (mini 3D CNN) sigmoid scorer as an artefact."""
    return _export_fwd(scorer_module("c", state, cfg, device=device),
                       clip_shape)


# each family's exporter, by family letter (the CLI's ``--family``)
EXPORTERS = {"a": export_family_a_scorer, "b": export_family_b_scorer,
             "c": export_family_c_scorer, "d": export_scorer,
             "e": export_family_e_scorer}


def _export_fwd(module: ScorerModule, clip_shape) -> bytes:
    """Trace `module` on a float32 (2,) + `clip_shape` example on its
    device, the batch a `torch.export.Dim` (min 1), and save it with the
    device in `ARTEFACT_META`."""
    dev = next(module.parameters()).device
    example = torch.zeros((_EXAMPLE_BATCH,) + tuple(clip_shape),
                          dtype=torch.float32, device=dev)
    batch = torch.export.Dim("batch", min=1)
    program = torch.export.export(module, (example,),
                                  dynamic_shapes=({0: batch},))
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        ARTEFACT_META: json.dumps({"device": dev.type,
                                   "family": module.family})})
    return buf.getvalue()


def artefact_meta(blob: bytes) -> dict:
    """The record an exported scorer carries: the device it runs on and
    its family."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        name = next((n for n in z.namelist()
                     if n.endswith(f"/extra/{ARTEFACT_META}")), None)
        if name is None:
            raise ValueError(f"no {ARTEFACT_META} in the archive: not a "
                             f"scorer exported by cvad_tpu_torch")
        return json.loads(z.read(name))


def clip_scorer(fn: Callable, device: torch.device) -> Callable:
    """numpy (N, T, H, W, C) clips, float32 in [0, 1] or uint8 pixels
    divided by 255 on `device` -> `fn`'s outputs as numpy (a tuple where it
    returns several), under ``torch.inference_mode()`` with TF32 off: how
    the eager scorers call their `ScorerModule` and `load_scorer` its
    artefact."""
    def score(batch: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        with torch.inference_mode(), no_tf32():
            out = fn(x)
        if isinstance(out, (tuple, list)):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    return score


def load_scorer(blob: bytes) -> Callable:
    """Run an exported scorer with no model code: (N, T, H, W, C) float32
    clips in [0, 1], or uint8 pixels divided by 255 on the device -> numpy
    (scores (N,), and the family's other outputs after them as a tuple).
    The artefact runs on the device it was exported on, TF32 off; a CUDA
    artefact on a host without CUDA raises (`resolve_device`).  The
    returned function's ``clip_shape`` is the artefact's (T, H, W, C),
    read from its input spec; its ``device`` and ``program`` (the loaded
    `ExportedProgram`) are the artefact's too."""
    dev = resolve_device(artefact_meta(blob)["device"])
    program = torch.export.load(io.BytesIO(blob))
    (name,) = program.graph_signature.user_inputs
    spec = next(n for n in program.graph.nodes
                if n.op == "placeholder" and n.name == name)
    score = clip_scorer(program.module(), dev)
    score.clip_shape = tuple(int(d) for d in spec.meta["val"].shape[1:])
    score.device = dev
    score.program = program
    return score
