"""Video and clip scoring: sliding-window scoring of frame-folder videos,
family D's per-batch and bulk (throughput) scorers and family B's combined
scorer.

Port of `cvad_tpu/evaluation/scoring.py`: `ScoredClip`, `VideoScorer`
(every window of a video decoded through `ClipDataset` and scored in
batches of `batch_size`, the per-frame curve the mean of the windows
covering each frame), `make_family_d_score_fn`,
`make_family_d_bulk_score_fn`, `make_family_b_score_fn`, `make_score_fn`
(families 'd', 'b', 'c', 'a' and 'e'), `make_sharded_score_fn` (families
'd' and 'c' over the mesh's data axis) and `aggregate_frame_scores`.  The public
functions take (N, T, H, W, C) clips, float32 in [0, 1] or raw uint8 pixels,
as `cvad_tpu`'s do; the clips are copied to the device once and normalised
there (uint8 / 255).  Each family's scorer is its `serving.ScorerModule`,
the module the exporters trace: it permutes the clips to the model's
layout, (N, C, T, H, W) for families D, C and E, (N, T, C, H, W) for
families B and A, and runs the model in ``eval()`` (no dropout; BatchNorm
on running statistics), here under ``torch.inference_mode()``.

Precision on the card: a float32 convolution goes through cuDNN in TF32 by
default, which keeps about three decimal digits.  The scorers run the model
inside ``torch.backends.cudnn.flags(allow_tf32=False)`` and leave
``torch.backends.cuda.matmul.allow_tf32`` at its default, False, so float32
scores are float32 throughout.  The flags are process-wide while a forward
runs; nothing is changed at import time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cvad_tpu_torch.config import (DataConfig, FamilyAConfig, FamilyBConfig,
                                   FamilyCConfig, FamilyDConfig, FamilyEConfig,
                                   LossConfig)
from cvad_tpu_torch.data.datasets import ClipDataset
from cvad_tpu_torch.data.frames import clip_windows, scan_video_folders
from cvad_tpu_torch.evaluation.serving import clip_scorer, scorer_module
from cvad_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass
class ScoredClip:
    """One window scoring above the threshold (the reference's
    anomalous-clip record)."""

    video: str
    start: int
    score: float
    frames: Tuple[str, ...]
    causal_graph: Optional[np.ndarray] = None


class VideoScorer:
    """Scores whole videos with a clip-level model.

    `score_fn(clips)` maps a (B, T, H, W, C) batch to per-clip scores in
    [0, 1], or to (scores, extras) such as family D's causal graphs; build
    one with `make_family_d_score_fn` or `make_family_b_score_fn`.  Each
    batch of windows is decoded on the host and scored in one call.
    """

    def __init__(self, score_fn: Callable, cfg: DataConfig,
                 batch_size: int = 64):
        self.score_fn = score_fn
        self.cfg = cfg
        self.batch_size = batch_size

    def score_video(self, frames: Sequence[str]) -> Dict[str, np.ndarray]:
        """Score every sliding window of one video: window 'starts',
        'scores', 'graphs' where the scorer returns them, and the per-frame
        curve 'frame_scores'."""
        cfg = self.cfg
        clips = clip_windows([("v", list(frames))], cfg.clip_len, cfg.stride)
        ds = ClipDataset(clips, np.zeros(len(clips), np.float32), cfg)
        starts = np.array([c.start for c in clips])
        scores = np.empty(len(clips), np.float32)
        graphs: List[np.ndarray] = []
        for s in range(0, len(clips), self.batch_size):
            idx = range(s, min(s + self.batch_size, len(clips)))
            batch = np.stack([ds[i][0] for i in idx])
            out = self.score_fn(batch)
            if isinstance(out, tuple):
                clip_scores = out[0]
                graphs.append(np.asarray(out[1]))
            else:
                clip_scores = out
            scores[s:s + len(batch)] = np.asarray(clip_scores).reshape(-1)
        result: Dict[str, np.ndarray] = {
            "starts": starts, "scores": scores,
            "frame_scores": aggregate_frame_scores(starts, scores,
                                                   cfg.clip_len,
                                                   len(frames))}
        if graphs:
            result["graphs"] = np.concatenate(graphs)
        return result

    def extract_anomalous_clips(self, video_root: str,
                                threshold: float = 0.3,
                                max_clips: Optional[int] = None
                                ) -> List[ScoredClip]:
        """Every window of every video under `video_root` scoring above
        `threshold` (the reference's default 0.3), highest first."""
        out: List[ScoredClip] = []
        for name, frames in scan_video_folders(video_root):
            res = self.score_video(frames)
            graphs = res.get("graphs")
            for i, (start, score) in enumerate(zip(res["starts"],
                                                   res["scores"])):
                if score > threshold:
                    out.append(ScoredClip(
                        video=name, start=int(start), score=float(score),
                        frames=tuple(frames[start:start + self.cfg.clip_len]),
                        causal_graph=None if graphs is None else graphs[i]))
        out.sort(key=lambda c: c.score, reverse=True)
        return out[:max_clips] if max_clips else out


def aggregate_frame_scores(starts: np.ndarray, scores: np.ndarray,
                           clip_len: int, n_frames: int) -> np.ndarray:
    """Per-frame curve: mean score of all windows covering each frame."""
    acc = np.zeros(n_frames, np.float64)
    cnt = np.zeros(n_frames, np.float64)
    for s, sc in zip(starts, scores):
        acc[s:s + clip_len] += sc
        cnt[s:s + clip_len] += 1
    cnt[cnt == 0] = 1
    return (acc / cnt).astype(np.float32)


def prep_clips(clips: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) uint8 pixels or floats in [0, 1], already on the
    device -> contiguous float32 (N, C, T, H, W) in [0, 1]."""
    x = clips.float() / 255.0 if clips.dtype == torch.uint8 else clips.float()
    return x.permute(0, 4, 1, 2, 3).contiguous()


def prep_frames(clips: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) uint8 pixels or floats in [0, 1], already on the
    device -> contiguous float32 (N, T, C, H, W) in [0, 1]."""
    x = clips.float() / 255.0 if clips.dtype == torch.uint8 else clips.float()
    return x.permute(0, 1, 4, 2, 3).contiguous()


def _scorer(family: str, state: Mapping[str, torch.Tensor], cfg, *,
            device, memory=None, loss_cfg=None, first: bool = False,
            empty=None) -> Callable:
    """A family's eager scorer: its `serving.ScorerModule` (the one
    definition, which the exporters trace too) called on numpy clips by
    `serving.clip_scorer`; `first` keeps the first output only, `empty` is
    what an empty batch returns (no scores by default).  The returned
    function's ``device`` is the scorer's (`ClipScoringService` stages its
    batches in pinned memory for a CUDA one)."""
    dev = resolve_device(device)
    module = scorer_module(family, state, cfg, memory, loss_cfg, dev)
    run = clip_scorer(module, dev)
    none = np.zeros(0, np.float32) if empty is None else empty

    def score(batch: np.ndarray):
        if len(batch) == 0:
            return none
        out = run(batch)
        return out[0] if first else out

    score.device = dev
    return score


def _empty(cfg: FamilyDConfig) -> Tuple[np.ndarray, np.ndarray]:
    d = cfg.causal_dim
    return np.zeros(0, np.float32), np.zeros((0, d, d), np.float32)


def make_family_d_score_fn(state: Mapping[str, torch.Tensor],
                           cfg: Optional[FamilyDConfig] = None, *,
                           device=None) -> Callable:
    """Family-D scorer: (N, T, H, W, C) clips -> (scores (N,), adjacency
    (N, d, d)) as numpy.  `state` is the model's state dict (the reference
    ``.pth`` keys); `device` defaults to CUDA and raises without it."""
    cfg = cfg or FamilyDConfig()
    return _scorer("d", state, cfg, device=device, empty=_empty(cfg))


def make_family_d_bulk_score_fn(state: Mapping[str, torch.Tensor],
                                cfg: Optional[FamilyDConfig] = None, *,
                                dtype: str = "bfloat16", batch: int = 256,
                                device=None) -> Callable:
    """Throughput-mode family-D scorer for offline sweeps: scores any number
    of clips in chunks of `batch` (the last one padded by repeating its last
    clip, the padding trimmed from the result).  The conv stack and fc run in
    `dtype` unless `cfg` is given, whose dtype then holds.  Returns
    (scores (N,), adjacency (N, d, d)) as numpy."""
    cfg = cfg or FamilyDConfig(dtype=dtype)
    run = _scorer("d", state, cfg, device=device, empty=_empty(cfg))

    def score(clips: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = len(clips)
        if n == 0:
            return _empty(cfg)
        s_parts, a_parts = [], []
        for off in range(0, n, batch):
            part = clips[off:off + batch]
            keep = len(part)
            if keep < batch:
                part = np.concatenate(
                    [part, np.repeat(part[-1:], batch - keep, axis=0)])
            s, adj = run(part)
            s_parts.append(s[:keep])
            a_parts.append(adj[:keep])
        return np.concatenate(s_parts), np.concatenate(a_parts)

    return score


def make_family_b_score_fn(state: Mapping[str, torch.Tensor], memory=None,
                           loss_cfg: Optional[LossConfig] = None,
                           cfg: Optional[FamilyBConfig] = None, *,
                           device=None) -> Callable:
    """Family-B combined scorer: (N, T, H, W, C) uint8 or float32 clips ->
    scores (N,) as numpy, ``b_score_recon`` x recon MSE + ``b_score_memory``
    x memory distance (K3; 0.7 and 0.3, ``causal_anomaly_detection1.py:552``).

    `state` is the model's state dict (reference keys, with or without the
    port's ``memory_fill``); `memory`, a `MemoryBankState` (tensors or
    numpy), replaces the bank it holds.  As in `cvad_tpu`, the clips are not
    clamped to family B's (0.001, 0.999) here: the eval step clamps them,
    the scorer does not.  `device` defaults to CUDA and raises without it."""
    return _scorer("b", state, cfg, device=device, memory=memory,
                   loss_cfg=loss_cfg)


def make_family_c_score_fn(state: Mapping[str, torch.Tensor],
                           cfg: Optional[FamilyCConfig] = None, *,
                           device=None) -> Callable:
    """Family-C scorer: (N, T, H, W, C) uint8 or float32 clips -> scores
    (N,) as numpy, the classifier's sigmoid.  `state` is the model's state
    dict (the reference ``.pth`` keys); `device` defaults to CUDA and
    raises without it."""
    return _scorer("c", state, cfg, device=device)


def make_family_a_score_fn(state: Mapping[str, torch.Tensor],
                           cfg: Optional[FamilyAConfig] = None, *,
                           device=None) -> Callable:
    """Family-A scorer: (N, T, H, W, C) uint8 or float32 clips -> the
    blended ``anomaly_scores`` (N,) as numpy (the causal score alone in
    the anchor variant), from the deterministic eval forward (z = mu).
    `state` is the model's state dict (the reference ``.pth`` keys; its
    conv1 gives the input channels); `device` defaults to CUDA and raises
    without it."""
    return _scorer("a", state, cfg, device=device, first=True)


def make_family_e_score_fn(state: Mapping[str, torch.Tensor],
                           cfg: Optional[FamilyEConfig] = None, *,
                           device=None) -> Callable:
    """Family-E scorer: (N, T, H, W, C) uint8 or float32 clips -> scores
    (N,) as numpy, the classifier's sigmoid (dropout off).  `state` is the
    model's state dict (the reference ``.pth`` keys); `device` defaults to
    CUDA and raises without it.  uint8 clips are divided by 255, as the
    port's other scorers do (`cvad_tpu` casts them without dividing)."""
    return _scorer("e", state, cfg, device=device, first=True)


def make_score_fn(family: str, state: Mapping[str, torch.Tensor],
                  memory=None, *, cfg=None, device=None) -> Callable:
    """Per-family batch -> scores dispatcher (`cvad_tpu`'s): family 'd'
    returns (scores, adjacency), family 'b' scores against the bank in
    `state` unless `memory` is given, families 'c', 'a' and 'e' return
    scores.  `cfg` is the family's model config where it is not the
    default."""
    if family == "d":
        return make_family_d_score_fn(state, cfg, device=device)
    if family == "b":
        return make_family_b_score_fn(state, memory, cfg=cfg, device=device)
    if family == "c":
        return make_family_c_score_fn(state, cfg, device=device)
    if family == "a":
        return make_family_a_score_fn(state, cfg, device=device)
    if family == "e":
        return make_family_e_score_fn(state, cfg, device=device)
    raise KeyError(f"unknown family {family!r}")


def make_sharded_score_fn(state: Mapping[str, torch.Tensor], mesh=None,
                          family: str = "d", cfg=None, *,
                          device=None) -> Callable:
    """Data-parallel scorer (`cvad_tpu`'s, :314-362): each rank scores its
    rows of the batch, padded to a multiple of the data axis by repeating
    its last clip, and every rank gets the whole batch's outputs, gathered
    and trimmed.  Family 'd' returns (scores (N,), adjacency), family 'c'
    scores (N,).  `mesh` defaults to `create_mesh()` (the trivial one
    without a process group, where this is the family's plain scorer).
    Every rank must call it with the same batch size."""
    from cvad_tpu_torch.parallel.collectives import gather
    from cvad_tpu_torch.runtime.mesh import create_mesh, part

    if family not in ("d", "c"):
        raise KeyError(f"the sharded scorer has families 'd' and 'c', not "
                       f"{family!r}")
    mesh = mesh if mesh is not None else create_mesh()
    dev = resolve_device(device)
    module = scorer_module(family, state, cfg, device=dev)

    def fn(x: torch.Tensor):
        out = module(x)
        if isinstance(out, (tuple, list)):
            return tuple(gather(o, mesh.data) for o in out)
        return gather(out, mesh.data)

    run = clip_scorer(fn, dev)
    nd = mesh.shape["data"]

    def score(batch: np.ndarray):
        n = len(batch)
        pad = -n % nd
        if pad:
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)])
        out = run(part(batch, 0, mesh.data))
        if isinstance(out, tuple):
            return tuple(o[:n] for o in out)
        return out[:n]

    return score
