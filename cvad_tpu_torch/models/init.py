"""The reference's weight initialisers, drawn from an explicit generator.

Own copy of `cvad_tpu/models/init.py:33-57` for torch weight layouts: the
reference initialises family B's convs with kaiming-normal (fan_out,
leaky_relu with a = 0) and its denses with xavier-normal of gain 0.5, biases
zero (``causal_anomaly_detection1.py:29-42``); family C's convs with
kaiming-normal (fan_out, relu) and its denses with normal(0, 0.01)
(``minicausal_vad_complete3.py:76-88``).  `lecun_normal_` is flax's default
kernel initialiser, which `cvad_tpu` leaves on family A.  Every draw takes a
`torch.Generator`, so that a model's initial weights follow from a seed
without touching the global generator.  The two frameworks draw different
numbers from the same seed; tests carry weights across instead.
"""

from __future__ import annotations

import math

import torch


def _fans(weight: torch.Tensor):
    """(fan_in, fan_out) of a torch weight as torch counts them: dim 1 and
    dim 0 times the kernel size.  For a ConvTranspose2d weight (I, O, kH,
    kW) the 'fan_out' is I * kH * kW, which is also what `cvad_tpu` counts
    for its (kH, kW, O, I) transpose kernels."""
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


@torch.no_grad()
def kaiming_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator,
                            a: float = 0.0) -> torch.Tensor:
    """``nn.init.kaiming_normal_(w, a, mode='fan_out',
    nonlinearity='leaky_relu')``."""
    gain = math.sqrt(2.0 / (1 + a * a))
    std = gain / math.sqrt(_fans(weight)[1])
    return weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def xavier_normal_(weight: torch.Tensor, generator: torch.Generator,
                   gain: float = 1.0) -> torch.Tensor:
    """``nn.init.xavier_normal_`` of a dense (O, I) weight."""
    fan_in, fan_out = _fans(weight)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """flax's default kernel init, ``variance_scaling(1, 'fan_in',
    'truncated_normal')``: a normal truncated at 2 std, scaled so that the
    variance is 1 / fan_in."""
    std = (1.0 / _fans(weight)[0]) ** 0.5 / 0.87962566103423978
    return torch.nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                       generator=generator)
