"""Family E: the bbox-visualization stand-in model, in PyTorch.

Port of `cvad_tpu/models/family_e.py` (the simplified
``CausalAnomalyDetector`` of ``avenue_training_script_bbox.py:51-101``):
Conv3d 3->32 (k3, padding 1), ReLU, MaxPool3d(2), Conv3d 32->64, ReLU and
AdaptiveAvgPool3d((1, 4, 4)) give 1,024 features; a causal head (Linear
1024->256, ReLU, Linear 256->256, sigmoid) gives a 16x16 adjacency and a
classifier (Linear 1024->128, ReLU, Dropout(0.3), Linear 128->1, sigmoid)
the score.

Layout inside is torch's (B, C, T, H, W).  The features flatten channel
major, (C, T, H, W), which is the order `cvad_tpu` reaches by transposing
its (B, T, H, W, C) activations first (family_e.py:40), so its dense
weights apply here unchanged.  The module tree gives the reference's
state-dict keys (``encoder.{0,3}``, ``causal_net.{0,2}``,
``classifier.{0,3}``), so a reference-format ``.pth`` loads with
``load_state_dict(strict=True)``.  No TPU kernel is on this path in
`cvad_tpu` (its convs and denses are XLA ops), so the port runs
``F.conv3d`` and ``nn.Linear``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cvad_tpu_torch.config import FamilyEConfig


class BBoxVizDetector(nn.Module):
    """Clips (B, 3, 8, 64, 64) in [0, 1] -> (scores (B,), adjacency
    (B, 16, 16), features (B, 1024))."""

    def __init__(self, cfg: Optional[FamilyEConfig] = None, seed: int = 0):
        super().__init__()
        cfg = cfg or FamilyEConfig()
        self.cfg = cfg
        c1, c2 = cfg.conv_channels
        d = cfg.causal_dim
        feats = c2 * 4 * 4
        # torch's default initialisation (the reference's), drawn from a
        # generator seeded with `seed` and leaving the global one as it was
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            self.encoder = nn.Sequential(
                nn.Conv3d(cfg.in_channels, c1, 3, padding=1), nn.ReLU(),
                nn.MaxPool3d(2), nn.Conv3d(c1, c2, 3, padding=1), nn.ReLU(),
                nn.AdaptiveAvgPool3d((1, 4, 4)))
            self.causal_net = nn.Sequential(
                nn.Linear(feats, cfg.hidden), nn.ReLU(),
                nn.Linear(cfg.hidden, d * d), nn.Sigmoid())
            self.classifier = nn.Sequential(
                nn.Linear(feats, 128), nn.ReLU(), nn.Dropout(0.3),
                nn.Linear(128, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feats = self.encoder(x).flatten(1)
        d = self.cfg.causal_dim
        adj = self.causal_net(feats).reshape(-1, d, d)
        return self.classifier(feats)[:, 0], adj, feats
