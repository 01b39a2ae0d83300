"""Family D — the flagship causal anomaly detector, in PyTorch.

Port of `cvad_tpu/models/family_d.py`: a 3D-CNN clip encoder gives 16
"causal variables", a NOTEARS-inspired head predicts a per-sample 16x16
adjacency, a graph encoder embeds the flattened adjacency, and a predictor
scores cat[features, graph embedding].

The layout inside is torch's (B, C, T, H, W).  Module names give the
reference's state-dict keys, so a reference ``best_improved_model.pth``
loads with ``load_state_dict(strict=True)``.  With ``cfg.dtype='bfloat16'``
the conv stack and ``fc`` run in bf16 by explicit casts (parameters stay
float32), and the heads run in float32, as in `cvad_tpu`.  Otherwise
everything runs in the parameters' type: float32, or float64 for a model
cast with ``.double()`` (a float64 reference on the CPU).

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
from cvad_tpu_torch.models.layers import (TFoldConv1, adaptive_avg_pool3d,
                                          dropout, window_overlap)
from cvad_tpu_torch.ops.pallas_conv import fold_group_size


def _resolve_lowering(cfg: FamilyDConfig, on_cpu: bool) -> Tuple[str, str]:
    """(conv_stack, conv1_mode) with 'auto' resolved as `cvad_tpu` does
    (family_d.py:29-51), by the input's device: 'folded' / 'tfold' on
    CUDA, 'ndhwc' / 'native' on the CPU."""
    stack, conv1 = cfg.conv_stack, cfg.conv1_mode
    if stack == "auto":
        stack = "ndhwc" if on_cpu else "folded"
    if conv1 == "auto":
        conv1 = "native" if on_cpu else "tfold"
    return stack, conv1


def conv1_route(cfg: FamilyDConfig, t: int, h: int, w: int, on_cpu: bool
                ) -> str:
    """'s2d' where `cvad_tpu` runs conv1 through ``s2d_group_conv`` (K5),
    'tfold' (K1) for every other lowering, for clips (T, H, W); raises
    where `cvad_tpu` raises.  The rules of family_d.py:69-116 and
    layers.py:167-200 and 420-442: the folded stack derives conv1's mode
    from the stack and ignores `conv1_mode`; the ndhwc stack keeps a
    'tfold' mode at long T only with 'gconv' or 's2d'; a group-wise fold
    (g = `fold_group_size` < T) with 'tfold2' / 'tfold3' raises.  (Its
    rule that 's2d' needs spatial stride 2 cannot fire: family D's conv1
    has stride 2.)"""
    stack, mode = _resolve_lowering(cfg, on_cpu)
    gi = cfg.conv_group_impl
    g = fold_group_size(t, cfg.conv_channels[0])
    whole_t = t >= 2 and g == t  # layers.py::_useful_fold
    even = h % 2 == 0 and w % 2 == 0
    if (stack in ("folded", "folded2", "folded3") and even
            and (whole_t or (gi in ("gconv", "s2d") and g >= 2))):
        mode = {"folded2": "tfold2", "folded3": "tfold3"}.get(stack, "tfold")
    elif (mode in ("tfold", "tfold_pallas") and not whole_t
          and gi not in ("gconv", "s2d")):
        mode = "native"
    if (mode not in ("tfold", "tfold2", "tfold3", "tfold_pallas")
            or not even or g < 2 or g == t):
        return "tfold"  # not a group-wise T fold: K1 computes the conv
    if mode not in ("tfold", "tfold_pallas"):
        raise ValueError(f"conv1_mode {mode!r} folds whole T only; T={t} "
                         f"folds group-wise (g={g}) and needs 'tfold'")
    return "s2d" if gi == "s2d" else "tfold"


def pool3d(x: torch.Tensor, out: Tuple[int, int, int]) -> torch.Tensor:
    """The adaptive average pool of conv3's output (N, C, T, H, W):
    `F.adaptive_avg_pool3d` where at most two windows share an input cell
    (its CUDA backward's atomic sums of two terms have one result), else
    `layers.adaptive_avg_pool3d`, whose backward sums in a fixed order (at
    16x16 frames, (2, 2, 2) -> (4, 4, 4), eight windows share each cell)."""
    shared = math.prod(window_overlap(i, o) for i, o in zip(x.shape[2:], out))
    if shared > 2:
        return adaptive_avg_pool3d(x, out)
    return F.adaptive_avg_pool3d(x, out)


def _conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """`conv` applied in x's dtype."""
    return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride, conv.padding)


class CompactFeatureExtractor(nn.Module):
    """3D CNN clip encoder -> `causal_dim` features: convs 3->16->32->64
    with strides (1,2,2)/(2,2,2)/(2,2,2), adaptive average pool to (4,4,4),
    fc 4096->16, dropout after the fc.  Conv1 runs K1 or, where
    `conv1_route` says so for the clip's shape and device, K5."""

    def __init__(self, cfg: FamilyDConfig):
        super().__init__()
        c1, c2, c3 = cfg.conv_channels
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.pool_out = tuple(cfg.pool_out)
        self.conv3d_1 = TFoldConv1(cfg.in_channels, c1)
        self.conv3d_2 = nn.Conv3d(c1, c2, 3, stride=2, padding=1)
        self.conv3d_3 = nn.Conv3d(c2, c3, 3, stride=2, padding=1)
        self.fc = nn.Linear(c3 * math.prod(self.pool_out), cfg.causal_dim)
        self.p = cfg.dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        heads = self.fc.weight.dtype  # the parameters' type
        x = x.to(self.dtype if self.dtype == torch.bfloat16 else heads)
        route = conv1_route(self.cfg, *x.shape[2:],
                            on_cpu=x.device.type == "cpu")
        x = F.relu(self.conv3d_1(x, route))
        x = F.relu(_conv(self.conv3d_2, x))
        x = F.relu(_conv(self.conv3d_3, x))
        # (2, 8, 8) -> (4, 4, 4) at 8x64x64 clips: T is oversampled; at 64
        # frames (16, 8, 8) -> (4, 4, 4)
        x = pool3d(x, self.pool_out)
        # NCTHW flattens channel-major, the order the reference fc expects
        x = x.reshape(x.shape[0], -1)
        x = F.linear(x, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))
        return dropout(x, self.p, self.training, generator).to(heads)


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
    """tr((batch-mean adjacency)^2), the stabilised NOTEARS surrogate.  The
    diagonal's sum, not ``torch.trace``: trace's backward fills the
    diagonal with ``index_fill_`` of a tensor value, a host read that a
    captured CUDA graph refuses."""
    m = adj.mean(dim=0)
    return torch.diagonal(m @ m).sum()


class CausalAnomalyDetector(nn.Module):
    """Full family-D model: clips (B, C=3, T, H=64, W=64) in [0, 1], T=8
    as trained or a long window such as T=64 -> (scores (B, 1), adjacency
    (B, 16, 16), features (B, 16))."""

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
        return self.heads(self.feature_extractor(clips, generator), generator)

    def heads(self, features: torch.Tensor,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Everything after the feature extractor: (scores, adjacency,
        `features`) from the (B, causal_dim) features (the temporally
        sharded forward's tail, `parallel/temporal.py`)."""
        adj = self.causal_discovery(features)
        ge = self.graph_encoder
        g = F.relu(ge[0](adj.reshape(adj.shape[0], -1)))
        g = ge[3](dropout(g, self.cfg.dropout, self.training, generator))
        scores = self.anomaly_predictor(torch.cat([features, g], dim=-1))
        return scores, adj, features
