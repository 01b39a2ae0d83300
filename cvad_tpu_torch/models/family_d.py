"""Family D — the flagship causal anomaly detector, in PyTorch.

Port of `cvad_tpu/models/family_d.py`: a 3D-CNN clip encoder gives 16
"causal variables", a NOTEARS-inspired head predicts a per-sample 16x16
adjacency, a graph encoder embeds the flattened adjacency, and a predictor
scores cat[features, graph embedding].

The layout inside is torch's (B, C, T, H, W).  Module names give the
reference's state-dict keys, so a reference ``best_improved_model.pth``
loads with ``load_state_dict(strict=True)``.  With ``cfg.dtype='bfloat16'``
the conv stack and ``fc`` run in bf16 by explicit casts (parameters stay
float32), and the heads run in float32, as in `cvad_tpu`.

Dropout (``cfg.dropout``, after ``fc`` and inside the graph encoder) applies
in ``train()`` mode, the counterpart of flax's ``deterministic=False``, and
draws its masks from the `torch.Generator` the caller passes to `forward`
(the counterpart of flax's dropout rng; torch's default generator when
none is given).  It keeps each value with probability 1 - p and scales it
by 1 / (1 - p), as flax does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvad_tpu_torch.config import FamilyDConfig
from cvad_tpu_torch.models.layers import TFoldConv1


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawn from `generator` (`nn.Dropout` cannot take
    one); the identity outside training or at p = 0."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """`conv` applied in x's dtype."""
    return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride, conv.padding)


class CompactFeatureExtractor(nn.Module):
    """3D CNN clip encoder -> `causal_dim` features: convs 3->16->32->64
    with strides (1,2,2)/(2,2,2)/(2,2,2), adaptive average pool to (4,4,4),
    fc 4096->16, dropout after the fc."""

    def __init__(self, cfg: FamilyDConfig):
        super().__init__()
        c1, c2, c3 = cfg.conv_channels
        self.dtype = getattr(torch, cfg.dtype)
        self.pool_out = tuple(cfg.pool_out)
        self.conv3d_1 = TFoldConv1(cfg.in_channels, c1)
        self.conv3d_2 = nn.Conv3d(c1, c2, 3, stride=2, padding=1)
        self.conv3d_3 = nn.Conv3d(c2, c3, 3, stride=2, padding=1)
        self.fc = nn.Linear(c3 * math.prod(self.pool_out), cfg.causal_dim)
        self.p = cfg.dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        x = F.relu(self.conv3d_1(x))
        x = F.relu(_conv(self.conv3d_2, x))
        x = F.relu(_conv(self.conv3d_3, x))
        # (2, 8, 8) -> (4, 4, 4) at 8x64x64 clips: T is oversampled
        x = F.adaptive_avg_pool3d(x, self.pool_out)
        # NCTHW flattens channel-major, the order the reference fc expects
        x = x.reshape(x.shape[0], -1)
        x = F.linear(x, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))
        return dropout(x, self.p, self.training, generator).float()


class DifferentiableCausalDiscovery(nn.Module):
    """Adjacency head: MLP 16 -> 32 -> 256, sigmoid, reshaped to (B, 16, 16)
    with the diagonal masked (no self-loops)."""

    def __init__(self, cfg: FamilyDConfig):
        super().__init__()
        d = cfg.causal_dim
        self.causal_dim = d
        self.causal_net = nn.Sequential(
            nn.Linear(d, cfg.causal_hidden), nn.ReLU(),
            nn.Linear(cfg.causal_hidden, d * d), nn.Sigmoid())

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        d = self.causal_dim
        adj = self.causal_net(features).view(features.shape[0], d, d)
        eye = torch.eye(d, dtype=adj.dtype, device=adj.device)
        return adj * (1.0 - eye)


def acyclicity_constraint(adj: torch.Tensor) -> torch.Tensor:
    """tr((batch-mean adjacency)^2), the stabilised NOTEARS surrogate."""
    m = adj.mean(dim=0)
    return torch.trace(m @ m)


class CausalAnomalyDetector(nn.Module):
    """Full family-D model: clips (B, C=3, T=8, H=64, W=64) in [0, 1] ->
    (scores (B, 1), adjacency (B, 16, 16), features (B, 16))."""

    def __init__(self, cfg: FamilyDConfig = FamilyDConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.causal_dim
        self.feature_extractor = CompactFeatureExtractor(cfg)
        self.causal_discovery = DifferentiableCausalDiscovery(cfg)
        # the reference's layout, so the state-dict keys are graph_encoder.0
        # and .3; forward applies the layers one by one, with `dropout`
        self.graph_encoder = nn.Sequential(
            nn.Linear(d * d, cfg.hidden_dim), nn.ReLU(),
            nn.Dropout(cfg.dropout),
            nn.Linear(cfg.hidden_dim, cfg.graph_embed_dim))
        self.anomaly_predictor = nn.Sequential(
            nn.Linear(d + cfg.graph_embed_dim, 32), nn.ReLU(),
            nn.Linear(32, 1), nn.Sigmoid())

    def forward(self, clips: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """`generator` feeds dropout's masks in ``train()`` mode."""
        features = self.feature_extractor(clips, generator)
        adj = self.causal_discovery(features)
        ge = self.graph_encoder
        g = F.relu(ge[0](adj.reshape(adj.shape[0], -1)))
        g = ge[3](dropout(g, self.cfg.dropout, self.training, generator))
        scores = self.anomaly_predictor(torch.cat([features, g], dim=-1))
        return scores, adj, features
