"""Family C: the minimal 3D-CNN anomaly classifier, in PyTorch.

Port of `cvad_tpu/models/family_c.py` (the reference's
``SimpleVideoAnomalyDetector``, ``minicausal_vad_complete3.py:25-102``):
three blocks of Conv3d (k3, stride 1, padding 1), BatchNorm, ReLU and max
pool, 1->8->16->32, pooling (1, 2, 2) then (2, 2, 2) twice; a global
average pool; and a classifier Dropout(0.5), Linear 32->16, ReLU,
Dropout(``cfg.dropout``), Linear 16->8, ReLU, Linear 8->1, sigmoid.

Layout inside is torch's (B, C, T, H, W).  The module tree gives the
reference's state-dict keys (``features.{0,4,8}`` convs,
``features.{1,5,9}`` BatchNorms, ``classifier.{1,4,6}`` Linears), so a
reference ``.pth`` loads with ``load_state_dict(strict=True)``.  The convs
run ``F.conv3d`` (cuDNN on the card): `cvad_tpu` runs no Pallas kernel on
this stride-1 conv (pallas_conv.py:254-259), whatever its own
``model.conv_mode`` (a knob the port does not carry).
With ``cfg.dtype='bfloat16'`` the conv blocks run in bf16 by explicit
casts; the parameters, the BatchNorm statistics and the head stay float32,
as in `cvad_tpu`.  Otherwise everything runs in the parameters' type
(float64 for a copy cast with ``.double()``, a reference on the CPU).  Dropout draws from the `torch.Generator` passed to
`forward` in ``train()`` mode, at each ``nn.Dropout``'s ``p``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvad_tpu_torch.config import FamilyCConfig
from cvad_tpu_torch.models.init import kaiming_normal_fan_out_
from cvad_tpu_torch.models.layers import (MaskedBatchNorm, accumulate,
                                          compute_dtype, max_pool3d, run_seq)

POOLS = ((1, 2, 2), (2, 2, 2), (2, 2, 2))  # minicausal_vad_complete3.py:41-53


class Simple3DCNNDetector(nn.Module):
    """Clips (B, C, T, H, W) in [0, 1] -> anomaly scores (B, 1) in [0, 1]."""

    def __init__(self, cfg: Optional[FamilyCConfig] = None, seed: int = 0):
        super().__init__()
        cfg = cfg or FamilyCConfig()
        self.cfg = cfg
        with torch.random.fork_rng(devices=[]):  # no global draw
            layers = []
            c_in = cfg.in_channels
            for c, pool in zip(cfg.conv_channels, POOLS):
                layers += [nn.Conv3d(c_in, c, 3, padding=1),
                           MaskedBatchNorm(c), nn.ReLU(),
                           nn.MaxPool3d(pool)]
                c_in = c
            self.features = nn.Sequential(*layers)
            m1, m2 = cfg.mlp_dims
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Linear(c_in, m1), nn.ReLU(),
                nn.Dropout(cfg.dropout), nn.Linear(m1, m2), nn.ReLU(),
                nn.Linear(m2, 1), nn.Sigmoid())
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """The reference's scheme (:76-88) from a generator seeded with
        `seed`, in module order: kaiming-normal fan_out convs,
        normal(0, 0.01) Linears, zero biases."""
        gen = torch.Generator().manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Conv3d):
                kaiming_normal_fan_out_(mod.weight, gen)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.01, generator=gen)
                mod.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                valid: Optional[torch.Tensor] = None,
                capture: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        """`valid` (B,) keeps padded rows out of the BatchNorm statistics in
        ``train()`` mode; `generator` feeds dropout's masks there;
        `capture` collects each block's BatchNorm output (before its
        ReLU)."""
        dtype = compute_dtype(self.cfg.dtype, self.classifier[1].weight)
        x = x.to(dtype)
        for layer in self.features:
            if isinstance(layer, nn.Conv3d):
                x = F.conv3d(x, layer.weight.to(dtype), layer.bias.to(dtype),
                             padding=1)
            elif isinstance(layer, MaskedBatchNorm):
                x = layer(x, valid=valid)
                if capture is not None:
                    capture.append(x)
            elif isinstance(layer, nn.MaxPool3d):
                x = max_pool3d(x, layer.kernel_size)
            else:
                x = layer(x)
        x = accumulate(x).mean((2, 3, 4))  # AdaptiveAvgPool3d(1) + flatten
        return run_seq(self.classifier, x, self.training, generator)
