"""Temporal attention for family B's long windows, in PyTorch.

Port of `cvad_tpu/ops/attention.py` (`flash_eligible`,
`multi_head_attention`, `TemporalAttentionBlock`,
`TemporalAttentionEncoder`, :33-113): a pre-LN transformer over the frame
latents (B, T, D) whose output, layer-normed and mean-pooled over T, is the
sequence feature.  Attention runs K6 (`ops/flash_attention.py`) where
`cvad_tpu` runs the Pallas flash kernel, reading "on TPU" as "on the CUDA
card": T a multiple of 128 and the head dim a multiple of 128.  Every other
shape, and every CPU tensor, takes the plain expression, as `cvad_tpu`
takes its jnp path (the default 64-wide latent with 4 heads never reaches
the kernel).

Arithmetic follows flax's modules: LayerNorm with epsilon 1e-6, `nn.gelu`
as the tanh approximation, one Dense of width 3D split q|k|v along its
outputs, a (max_len, D) position table sliced to T.  Module names follow
flax's (``pos_embed``, ``block_0.ln1``, ``block_0.qkv``, ... ``ln_out``),
and the denses take flax's default initialisation (lecun-normal, truncated
at two standard deviations; zero bias) from an explicit generator
(`reset_parameters`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvad_tpu_torch.ops.flash_attention import (attention_reference,
                                                flash_attention)

# the flash kernel's tiling constraints, as in cvad_tpu (:21-23)
_FLASH_MIN_T = 128
_FLASH_HEAD_DIM = 128
_LN_EPS = 1e-6  # flax's LayerNorm default (torch's is 1e-5)
_TRUNC = 0.87962566103423978  # std of a standard normal truncated at +-2


def flash_eligible(t: int, head_dim: int, device) -> bool:
    """Whether attention over T steps of `head_dim` runs the flash kernel on
    `device`: `cvad_tpu`'s rule with the CUDA card in the TPU's place."""
    return (torch.device(device).type == "cuda" and t >= _FLASH_MIN_T
            and t % _FLASH_MIN_T == 0 and head_dim % _FLASH_HEAD_DIM == 0)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False) -> torch.Tensor:
    """Attention over (B, H, T, Dh) tensors; the flash kernel when
    `flash_eligible`, else the plain expression."""
    t, dh = q.shape[2], q.shape[3]
    scale = dh ** -0.5
    if flash_eligible(t, dh, q.device):
        return flash_attention(q, k, v, causal=causal, sm_scale=scale)
    return attention_reference(q, k, v, causal=causal, sm_scale=scale)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation (torch's default is the
    exact erf form)."""
    return F.gelu(x, approximate="tanh")


@torch.no_grad()
def _lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init on a torch (out, in) weight."""
    std = (1.0 / weight.shape[1]) ** 0.5 / _TRUNC
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    weight.copy_(w)


class TemporalAttentionBlock(nn.Module):
    """Pre-LN transformer block over frame latents (B, T, D)."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: int = 4,
                 causal: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.causal = causal
        self.ln1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.mlp_0 = nn.Linear(dim, mlp_ratio * dim)
        self.mlp_2 = nn.Linear(mlp_ratio * dim, dim)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for dense in (self.qkv, self.proj, self.mlp_0, self.mlp_2):
            _lecun_normal_(dense.weight, gen)
            dense.bias.zero_()
        for ln in (self.ln1, self.ln2):
            ln.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h

        def heads(z):
            return z.reshape(b, t, h, dh).transpose(1, 2)

        q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)
        out = multi_head_attention(heads(q), heads(k), heads(v),
                                   causal=self.causal)
        x = x + self.proj(out.transpose(1, 2).reshape(b, t, d))
        y = gelu(self.mlp_0(self.ln2(x)))
        return x + self.mlp_2(y)


class TemporalAttentionEncoder(nn.Module):
    """(B, T, D) frame latents -> (B, D) sequence feature: position table,
    `num_layers` blocks, LayerNorm, mean over T."""

    def __init__(self, dim: int, num_layers: int = 2, num_heads: int = 4,
                 max_len: int = 4096, causal: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        for i in range(num_layers):
            self.add_module(f"block_{i}", TemporalAttentionBlock(
                dim, num_heads, causal=causal))
        self.ln_out = nn.LayerNorm(dim, eps=_LN_EPS)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's defaults, drawn from `gen`: the position table ~ N(0,
        0.02^2), then each block's denses in order."""
        pos = torch.empty(self.pos_embed.shape)
        self.pos_embed.copy_(pos.normal_(0.0, 0.02, generator=gen))
        for block in self.blocks():
            block.reset_parameters(gen)
        self.ln_out.reset_parameters()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        t = z.shape[1]
        if t > self.pos_embed.shape[0]:
            raise ValueError(f"T={t} exceeds the position table's "
                             f"{self.pos_embed.shape[0]} rows")
        x = z + self.pos_embed[:t][None]
        for block in self.blocks():
            x = block(x)
        return self.ln_out(x).mean(dim=1)
