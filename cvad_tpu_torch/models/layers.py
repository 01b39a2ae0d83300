"""Layers of the port's models.

`TFoldConv1` is family D's conv1 (`cvad_tpu.models.layers.Conv3dTorch` with
``mode='tfold_pallas'``, stride (1, 2, 2)): the same parameters as
``nn.Conv3d(3, 16, 3, stride=(1, 2, 2), padding=1)``, with the bias added
here, as `cvad_tpu` leaves the bias to the caller of its kernels.  Its
convolution runs by one of two routes, which the model picks
(`models/family_d.py::conv1_route`):

- ``'tfold'``: the K1 kernel (`cvad_tpu_torch.ops.pallas_conv.tfold_conv1`)
  at its widths, 3 -> 16; any other width (grayscale clips, a wider conv1)
  runs ``F.conv3d``, chosen by `pallas_conv.kernel_takes` from the
  weight's shape before any launch, as `cvad_tpu` runs XLA's conv at every
  width (pallas_conv.py:254-259).  On the card that is cuDNN's conv, in
  float32 without TF32 under the train step's and the scorers' cuDNN
  settings (`train/tasks.py::card_numerics`, `evaluation/scoring.py`);
- ``'s2d'``: the long-window route of `cvad_tpu`'s ``_TFoldConv`` with
  ``group_impl='s2d'`` (layers.py:177-200): space-to-depth and T-group fold
  of the input (`s2d_fold_groups`) and of the weight (`s2d_fold_kernel`,
  through which autograd carries the weight gradient back to the
  parameter), the K5 kernel (`s2d_group_conv`), and the t-major output
  (B, H/2, W/2, T*O) unfolded to (B, O, T, H/2, W/2).

`MaskedBatchNorm` is family B's BatchNorm2d (`cvad_tpu.models.layers.
MaskedBatchNorm`, :598-647).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvad_tpu_torch.ops.pallas_conv import (fold_group_size, kernel_takes,
                                            tfold_conv1)
from cvad_tpu_torch.ops.pallas_s2d import (s2d_fold_groups, s2d_fold_kernel,
                                           s2d_group_conv)


class TFoldConv1(nn.Module):
    """Conv3d(in_channels -> out_channels, k=3, stride=(1,2,2), padding=1)
    over (B, C, T, H, W), computed in the input's dtype (parameters stay
    float32).  The 'tfold' route runs K1 at C=3 -> O=16 and ``F.conv3d`` at
    every other width; the 's2d' route runs K5 at any width."""

    def __init__(self, in_channels: int = 3, out_channels: int = 16):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        # nn.Conv3d's default initialisation
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        bound = 1.0 / math.sqrt(in_channels * 27)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor, route: str = "tfold") -> torch.Tensor:
        """x (B, C, T, H, W) -> (B, O, T, Ho, Wo) by `route` ('tfold' or
        's2d', which needs even H and W and g = `fold_group_size` < T)."""
        w = self.weight.to(x.dtype)
        if route == "tfold" and kernel_takes(w.shape[1], w.shape[0]):
            y = tfold_conv1(x.contiguous(), w.contiguous())
        elif route == "tfold":
            y = F.conv3d(x, w, stride=(1, 2, 2), padding=1)
        elif route == "s2d":
            b, _, t, h, wd = x.shape
            o = w.shape[0]
            g = fold_group_size(t, o)
            xg = s2d_fold_groups(x.permute(0, 2, 3, 4, 1), g)
            wk = s2d_fold_kernel(w.permute(2, 3, 4, 1, 0), g)  # (kT..., C, O)
            y = s2d_group_conv(xg, wk, g)  # (B, H/2, W/2, T*O), t-major
            y = y.view(b, h // 2, wd // 2, t, o).permute(0, 4, 3, 1, 2)
            y = y.contiguous()
        else:
            raise ValueError(f"conv1 route {route!r}: 'tfold' or 's2d'")
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1, 1)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over dim 1 of (N, C, ...) with `cvad_tpu`'s arithmetic.

    - train mode (``self.training``): batch statistics in float32 (also for
      bf16 inputs), the biased variance E[x^2] - E[x]^2 clamped at 0, over
      the rows where `valid` (N,) is nonzero when it is given; the running
      statistics become ``0.9 * running + 0.1 * batch``, mean and variance
      alike (`torch.nn.BatchNorm2d` would take the unbiased variance);
    - eval mode: the running statistics;
    - out = (x - mean) * (rsqrt(var + eps) * weight) + bias, in x's dtype.

    Parameters and buffers carry `nn.BatchNorm2d`'s names (``weight``,
    ``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``),
    so a reference state dict loads strictly; ``num_batches_tracked``
    counts train-mode calls, as torch's does, and nothing reads it.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum  # flax convention: the running share
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = (0,) + tuple(range(2, x.dim()))
            if valid is None:
                mean = xf.mean(axes)
                mean2 = (xf * xf).mean(axes)
            else:
                w = valid.float().reshape((-1,) + (1,) * (x.dim() - 1))
                per_row = x[:, 0].numel() / x.shape[0]
                cnt = torch.clamp(valid.float().sum() * per_row, min=1.0)
                mean = (xf * w).sum(axes) / cnt
                mean2 = (xf * xf * w).sum(axes) / cnt
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return out.to(x.dtype)
