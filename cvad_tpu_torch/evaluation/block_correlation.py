"""Per-block channel correlations of the family-C 3D CNN.

Port of `cvad_tpu/evaluation/block_correlation.py::block_channel_correlations`
(:20-49): one eval forward captures each conv block's BatchNorm output,
ReLU is applied here (the block's output), and its channels are correlated
over every (sample, time, space) position; `plot_block_correlations`
(:52-77) draws them as the three-panel figure of ``cli plots
--block-correlation``.
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


def plot_block_correlations(mats: List[np.ndarray], out_path: str,
                            title: str = "Per-block feature correlations"
                            ) -> Optional[str]:
    """One heatmap a block, in the layout of the reference's shipped
    ``Figure 2025-09-04 180626.png``.  Returns the written path, or None
    without matplotlib."""
    from cvad_tpu_torch.evaluation.plots import _plt

    plt = _plt()
    if plt is None:
        return None
    fig, axes = plt.subplots(1, len(mats), figsize=(5 * len(mats), 4.4))
    axes = np.atleast_1d(axes)
    for i, (ax, corr) in enumerate(zip(axes, mats)):
        im = ax.imshow(corr, cmap="coolwarm", vmin=-1.0, vmax=1.0)
        c = corr.shape[0]
        ax.set_title(f"Block {i + 1} ({c}x{c})")
        ax.set_xlabel("channel")
        if i == 0:
            ax.set_ylabel("channel")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
