"""Per-block channel correlations of the family-C 3D CNN.

Port of `cvad_tpu/evaluation/block_correlation.py::block_channel_correlations`
(:20-49): one eval forward captures each conv block's BatchNorm output,
ReLU is applied here (the block's output), and its channels are correlated
over every (sample, time, space) position.  The three-panel figure
(`plot_block_correlations`, ``cli plots``) waits for the plots module
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch

from cvad_tpu_torch.config import FamilyCConfig
from cvad_tpu_torch.models import Simple3DCNNDetector
from cvad_tpu_torch.runtime.device import resolve_device
from cvad_tpu_torch.train.tasks import card_numerics


def block_channel_correlations(state: Mapping[str, torch.Tensor],
                               clips: np.ndarray,
                               cfg: Optional[FamilyCConfig] = None, *,
                               device=None) -> List[np.ndarray]:
    """One (C_i, C_i) Pearson matrix per conv block (8, 16 and 32 at the
    default widths) from (N, T, H, W, C) clips in [0, 1].  A constant
    channel (a dead ReLU) gives NaN rows: 0 off the diagonal, 1 on it.
    `state` is the model's state dict; `device` defaults to CUDA."""
    dev = resolve_device(device)
    model = Simple3DCNNDetector(cfg)
    model.load_state_dict(state, strict=True)
    model = model.to(dev).eval()
    x = torch.from_numpy(np.asarray(clips, np.float32)).to(dev)
    captured: List[torch.Tensor] = []
    with torch.inference_mode(), card_numerics():  # TF32 off
        model(x.permute(0, 4, 1, 2, 3).contiguous(), capture=captured)
    mats = []
    for act in captured:
        act = np.maximum(act.float().cpu().numpy(), 0.0)
        flat = np.moveaxis(act, 1, -1).reshape(-1, act.shape[1])  # (P, C)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.corrcoef(flat.T)
        corr = np.where(np.isfinite(corr), corr, 0.0)
        np.fill_diagonal(corr, 1.0)
        mats.append(corr)
    return mats
