"""Datasets of the port: the synthetic one only.

Port of `cvad_tpu/data/datasets.py::SyntheticClipDataset` (:162-186) and of
`build_dataset` for ``dataset='synthetic'``.  The frame-folder datasets
(UCSD Ped2, Avenue) wait for the data package (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cvad_tpu_torch.config import DataConfig
from cvad_tpu_torch.data.synthetic import make_synthetic_clips


class SyntheticClipDataset:
    """In-memory synthetic clips (fixtures and benchmarks; no host IO)."""

    def __init__(self, cfg: DataConfig, n: int = 256, split: str = "Train",
                 anomaly_rate: Optional[float] = None):
        rate = anomaly_rate
        if rate is None:
            rate = 0.2 if split.lower() == "train" else 0.5
        self.data, self.labels = make_synthetic_clips(
            n, cfg.clip_len, cfg.frame_size, cfg.channels, rate,
            seed=cfg.seed + (0 if split.lower() == "train" else 1),
            profile=cfg.synthetic_profile)
        lo, hi = cfg.normalize_clamp
        if (lo, hi) != (0.0, 1.0):
            self.data = np.clip(self.data, lo, hi)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int):
        return self.data[idx], self.labels[idx]

    def get_uint8(self, idx: int):
        return (np.round(self.data[idx] * 255.0).astype(np.uint8),
                self.labels[idx])


def build_dataset(cfg: DataConfig, split: str = "Train",
                  n_synthetic: int = 256) -> SyntheticClipDataset:
    if cfg.dataset == "synthetic":
        return SyntheticClipDataset(cfg, n=n_synthetic, split=split)
    if cfg.dataset in ("ucsd_ped2", "ucsd_ped2_simple", "avenue"):
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet: the frame-folder "
            f"datasets wait for the data package (ROADMAP Queue 1 item 6)")
    raise KeyError(f"unknown dataset {cfg.dataset!r}")
