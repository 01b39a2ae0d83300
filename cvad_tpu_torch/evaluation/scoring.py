"""Clip scoring: family D's per-batch and bulk (throughput) scorers and
family B's combined scorer.

Port of `cvad_tpu/evaluation/scoring.py::make_family_d_score_fn`,
`make_family_d_bulk_score_fn`, `make_family_b_score_fn`, `make_score_fn`
(families 'd' and 'b') and `aggregate_frame_scores`.  The public
functions take (N, T, H, W, C) clips, float32 in [0, 1] or raw uint8 pixels,
as `cvad_tpu`'s do; the clips are copied to the device once, normalised
there (uint8 / 255) and permuted there to the model's layout, (N, C, T,
H, W) for family D, (N, T, C, H, W) for family B.  The model runs in
``eval()`` (no dropout; BatchNorm on running statistics) under
``torch.inference_mode()``.

Precision on the card: a float32 convolution goes through cuDNN in TF32 by
default, which keeps about three decimal digits.  The scorers run the model
inside ``torch.backends.cudnn.flags(allow_tf32=False)`` and leave
``torch.backends.cuda.matmul.allow_tf32`` at its default, False, so float32
scores are float32 throughout.  The flags are process-wide while a forward
runs; nothing is changed at import time.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from cvad_tpu_torch.config import FamilyBConfig, FamilyDConfig, LossConfig
from cvad_tpu_torch.models import CausalAnomalyDetector, MemoryVideoAutoEncoder
from cvad_tpu_torch.models.family_b import MemoryBankState
from cvad_tpu_torch.runtime.device import resolve_device


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


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _load(state: Mapping[str, torch.Tensor], cfg: FamilyDConfig,
          device: torch.device) -> CausalAnomalyDetector:
    model = CausalAnomalyDetector(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def _forward(model: CausalAnomalyDetector, clips: np.ndarray,
             device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    x = prep_clips(torch.from_numpy(np.ascontiguousarray(clips)).to(device))
    with torch.inference_mode(), _no_tf32():
        scores, adj, _ = model(x)
        return (scores.reshape(-1).cpu().numpy(), adj.cpu().numpy())


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
    dev = resolve_device(device)
    model = _load(state, cfg, dev)

    def score(batch: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if len(batch) == 0:
            return _empty(cfg)
        return _forward(model, batch, dev)

    return score


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
    dev = resolve_device(device)
    model = _load(state, cfg, dev)

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
            s, adj = _forward(model, part, dev)
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
    cfg = cfg or FamilyBConfig()
    w = loss_cfg or LossConfig()
    dev = resolve_device(device)
    model = MemoryVideoAutoEncoder(cfg)
    model.load_state_dict(state, strict=True)
    model = model.to(dev).eval()
    if memory is not None:
        model.set_memory_bank(MemoryBankState(*(
            torch.as_tensor(np.asarray(v)).to(dev) for v in memory)))

    def score(batch: np.ndarray) -> np.ndarray:
        if len(batch) == 0:
            return np.zeros(0, np.float32)
        x = prep_frames(torch.from_numpy(np.ascontiguousarray(batch)).to(dev))
        with torch.inference_mode(), _no_tf32():
            out = model(x)
            recon = ((out["reconstructed"] - x) ** 2).mean((1, 2, 3, 4))
            s = w.b_score_recon * recon + w.b_score_memory * \
                out["anomaly_score"]
            return s.cpu().numpy()

    return score


def make_score_fn(family: str, state: Mapping[str, torch.Tensor],
                  memory=None, *, device=None) -> Callable:
    """Per-family batch -> scores dispatcher (`cvad_tpu`'s, for the ported
    families): family 'd' returns (scores, adjacency), family 'b' scores
    against the bank in `state` unless `memory` is given."""
    if family == "d":
        return make_family_d_score_fn(state, device=device)
    if family == "b":
        return make_family_b_score_fn(state, memory, device=device)
    raise NotImplementedError(
        f"family {family!r} has no scorer in the port yet; families 'd' and "
        f"'b' are ported (ROADMAP Queue 1 items 9-11)")
