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

`MaskedBatchNorm` is the BatchNorm of families B, C and A
(`cvad_tpu.models.layers.MaskedBatchNorm`, :598-647).  `max_pool3d`,
`adaptive_avg_pool2d` and `mlp` are the counterparts of `cvad_tpu`'s
helpers of the same names (:504-595) for families C and A; `run_seq`
applies such a stack in a compute dtype with dropout from a generator.
`adaptive_avg_pool3d` is family D's pool where more than two windows share
an input cell (`family_d.pool3d`): its backward repeats bit for bit on the
card, `F.adaptive_avg_pool3d`'s does not there.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvad_tpu_torch.ops.pallas_conv import (fold_group_size, kernel_takes,
                                            tfold_conv1)
from cvad_tpu_torch.ops.pallas_s2d import (s2d_fold_groups, s2d_fold_kernel,
                                           s2d_group_conv)
from cvad_tpu_torch.parallel.collectives import all_reduce_sum, random
from cvad_tpu_torch.runtime.mesh import single_mesh


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
      bf16 inputs; float64 for a float64 model), the biased variance E[x^2] - E[x]^2 clamped at 0, over
      the rows where `valid` (N,) is nonzero when it is given; the running
      statistics become ``0.9 * running + 0.1 * batch``, mean and variance
      alike (`torch.nn.BatchNorm2d` would take the unbiased variance);
    - eval mode: the running statistics;
    - out = (x - mean) * (rsqrt(var + eps) * weight) + bias, in x's dtype.

    The statistics are those of the rows of every rank of the mesh's data
    axis (``axis``: the trivial mesh's, one device, until
    `parallel.collectives.bind_batchnorm` sets the mesh's), so that the
    running statistics update alike on every rank.

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
        self.axis = single_mesh().data  # the data axis the batch spans

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                update_stats: bool = True) -> torch.Tensor:
        """`update_stats=False` normalises with the batch statistics in
        train mode without touching the running ones (a recomputation of
        the same forward, as under ``torch.utils.checkpoint``)."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self._batch_stats(xf, valid)
            m = self.momentum
            if update_stats:
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

    def _batch_stats(self, xf: torch.Tensor, valid: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, biased variance) over the rows `valid` keeps, of every
        rank of the data axis: the count, sum and sum of squares summed
        over the ranks in one `all_reduce_sum`.  Without a process group
        that sum is the identity, and the three are not packed for it
        (packing copies exactly, so both give the same bits)."""
        axes = (0,) + tuple(range(2, xf.dim()))
        if valid is None:
            cnt = xf.new_full((1,), xf[:, 0].numel())
            s1, s2 = xf.sum(axes), (xf * xf).sum(axes)
        else:
            w = valid.to(xf.dtype).reshape((-1,) + (1,) * (xf.dim() - 1))
            per_row = xf[:, 0].numel() / xf.shape[0]
            cnt = (valid.to(xf.dtype).sum() * per_row).reshape(1)
            s1, s2 = (xf * w).sum(axes), (xf * xf * w).sum(axes)
        if self.axis.group is not None:
            c = s1.shape[0]
            cnt, s1, s2 = all_reduce_sum(torch.cat([cnt, s1, s2]),
                                         self.axis).split([1, c, c])
        cnt = torch.clamp(cnt, min=1.0)
        mean = s1 / cnt
        var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
        return mean, var


def max_pool3d(x: torch.Tensor, kernel: Tuple[int, int, int],
               stride: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Max pool over (B, C, T, H, W) without padding, ``nn.MaxPool3d``'s
    (`cvad_tpu`'s flax pool with 'VALID' padding)."""
    return F.max_pool3d(x, kernel, stride or kernel)


def adaptive_slices(in_size: int, out_size: int) -> List[Tuple[int, int]]:
    """torch's adaptive-pool windows [floor(i*in/out), ceil((i+1)*in/out))
    (`cvad_tpu`'s ``_adaptive_slices``)."""
    return [(math.floor(i * in_size / out_size),
             math.ceil((i + 1) * in_size / out_size))
            for i in range(out_size)]


def adaptive_avg_pool2d(x: torch.Tensor, out: Tuple[int, int]
                        ) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, oh, ow), ``F.adaptive_avg_pool2d``'s windows,
    also where the output is larger than the input (windows repeat).  As in
    `cvad_tpu`: one reshaped mean where the output divides the input, else
    the mean of each window along H, then along W."""
    n, c, h, w = x.shape
    oh, ow = out
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean((3, 5))
    return _pool_axis(_pool_axis(x, 2, oh), 3, ow)


def _pool_axis(a: torch.Tensor, dim: int, o: int) -> torch.Tensor:
    """The mean of each of `adaptive_slices`' windows along `dim`."""
    return torch.cat([a.narrow(dim, s, e - s).mean(dim, keepdim=True)
                      for s, e in adaptive_slices(a.shape[dim], o)], dim)


def window_overlap(in_size: int, out_size: int) -> int:
    """The most adaptive-pool windows that share one input cell along an
    axis of `in_size` pooled to `out_size`."""
    share = [0] * in_size
    for s, e in adaptive_slices(in_size, out_size):
        for i in range(s, e):
            share[i] += 1
    return max(share)


def adaptive_avg_pool3d(x: torch.Tensor, out: Tuple[int, int, int]
                        ) -> torch.Tensor:
    """(N, C, T, H, W) -> (N, C, ot, oh, ow) over ``F.adaptive_avg_pool3d``'s
    windows, as the mean of each window along T, then H, then W
    (`narrow`, `mean`, `cat`).  Its backward is autograd's, which adds the
    gradients an input cell takes from the windows sharing it in a fixed
    order; `F.adaptive_avg_pool3d`'s CUDA backward adds them with atomics,
    in no fixed order once more than two windows share a cell."""
    for dim, o in zip((2, 3, 4), out):
        x = _pool_axis(x, dim, o)
    return x


ACTIVATIONS = {"sigmoid": nn.Sigmoid, "relu": nn.ReLU, "tanh": nn.Tanh}


def mlp(in_features: int, features: Sequence[int],
        final_activation: Optional[str] = None, dropout: float = 0.0,
        dropout_after: Sequence[int] = (),
        dropout_rates: Optional[Sequence[float]] = None) -> nn.Sequential:
    """`cvad_tpu`'s ``MLP`` as the reference's ``nn.Sequential``: Linear,
    ReLU between layers, ``nn.Dropout`` after the layers in `dropout_after`
    (at `dropout_rates`, else `dropout`), then the final activation
    ('sigmoid', 'softmax', 'tanh', 'relu' or None).  The indices of the
    Linears are the reference's state-dict keys (e.g. 0, 3, 6, 8 for
    (512, 256, 128, 64) with dropout after 0 and 1)."""
    rates = {i: (dropout_rates[j] if dropout_rates is not None else dropout)
             for j, i in enumerate(dropout_after)}
    layers: List[nn.Module] = []
    for i, f in enumerate(features):
        layers.append(nn.Linear(in_features, f))
        in_features = f
        if i < len(features) - 1:
            layers.append(nn.ReLU())
        if rates.get(i, 0.0) > 0:
            layers.append(nn.Dropout(rates[i]))
    if final_activation == "softmax":
        layers.append(nn.Softmax(dim=-1))
    elif final_activation is not None:
        layers.append(ACTIVATIONS[final_activation]())
    return nn.Sequential(*layers)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawn from `generator` (`nn.Dropout` cannot take
    one; a `parallel.collectives.RowDraws` draws this rank's rows of the
    global batch's mask), as flax's: keep with probability 1 - p, scale
    by 1 / (1 - p); the identity outside training or at p = 0."""
    if not training or p == 0.0:
        return x
    keep = random(x.shape, generator, x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def compute_dtype(dtype: str, params: torch.Tensor) -> torch.dtype:
    """A model's compute dtype: bfloat16 where its config says so, else the
    parameters' type (float32, or float64 for a copy cast with
    ``.double()``, a reference on the CPU)."""
    return torch.bfloat16 if dtype == "bfloat16" else params.dtype


def accumulate(x: torch.Tensor) -> torch.Tensor:
    """`x` in at least float32: what the heads, statistics and losses
    accumulate in whatever the compute dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer` applied in x's dtype (its float32 parameters cast to it)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def run_seq(seq: nn.Sequential, x: torch.Tensor, training: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply an `mlp` stack in x's dtype (the Linears' float32 parameters
    cast to it), its ``nn.Dropout`` layers at their ``p`` through `dropout`
    with `generator` in training."""
    for layer in seq:
        if isinstance(layer, nn.Linear):
            x = linear(layer, x)
        elif isinstance(layer, nn.Dropout):
            x = dropout(x, layer.p, training, generator)
        else:
            x = layer(x)
    return x
