"""Family B: the memory-bank video autoencoder, in PyTorch.

Port of `cvad_tpu/models/family_b.py` (the reference's ``VideoAutoEncoder``,
``causal_anomaly_detection1.py:124-321``): a per-frame conv encoder to a
tanh latent, a temporal encoder over the frame latents whose output is the
sequence feature, a deconv decoder that renders one frame from it (the
reference decodes the same feature T times; one decode broadcast over T is
the same), and a ring buffer of normal sequence features scored by min
cosine distance (K3).  The temporal encoder is an LSTM (its last hidden
state; ``temporal_encoder='lstm'``) or `cvad_tpu`'s attention encoder
(``'attention'``, `ops/attention.py`: a transformer mean-pooled over T,
whose attention runs K6 on the card where `cvad_tpu` runs the Pallas flash
kernel).  The bank is as wide as the sequence feature: ``lstm_hidden`` or
``latent_dim``, as `cvad_tpu` fills it.

Layout: frames are (B, T, C, H, W), as the reference's module takes them;
the encoder runs on the B*T frames folded into the batch.  The module tree
gives the reference's state-dict keys (the ones
`cvad_tpu.runtime.checkpoint.import_torch_family_b` reads):
``encoder.{0,3,6,9}`` convs, ``encoder.{1,4,7,10}`` BatchNorms,
``encoder.13`` fc; ``decoder.0`` fc, ``decoder.{3,6,9,12}`` deconvs,
``decoder.{4,7,10}`` BatchNorms; ``temporal_encoder.{weight_ih_l0,
weight_hh_l0, bias_ih_l0, bias_hh_l0}``; ``normal_memory`` and
``memory_ptr``.  The reference has no attention encoder: its keys are the
port's own and follow flax's module names (``temporal.pos_embed``,
``temporal.block_0.ln1``, ``temporal.block_0.qkv``, ...,
``temporal.ln_out``).  The port adds ``memory_fill``: the reference's
``memory_ptr`` doubles as its fill count, `cvad_tpu` tracks the fill apart
(so that a wrapped bank scores with all its rows), and so does the port.  A
state dict without ``memory_fill`` (the reference's) loads with fill = ptr,
as `import_torch_family_b` reads it.

The LSTM holds ONE bias per gate, as flax's cell does (on the h side): torch's
``bias_ih`` and ``bias_hh`` only ever appear as a sum, and two parameters
would each take a full Adam step, twice the one flax parameter's.  It is
saved as ``bias_ih_l0`` with ``bias_hh_l0`` zero, and a reference state dict
loads with the two summed.  Its forward is flax's cell written out (gates i,
f, g, o; zero initial carry): the input projection of all T frames in one
matmul, then per step one matmul of the hidden state; no cuDNN RNN, so that
TF32 and cuDNN's RNN algorithms stay out of card-vs-CPU checks and resumes.

The bank is the model's buffers; `memory_bank()` views it as a
`MemoryBankState`, the functional form `update_memory`,
`memory_anomaly_score` and the train step work on, and `set_memory_bank`
writes one back.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvad_tpu_torch.config import FamilyBConfig
from cvad_tpu_torch.models.init import kaiming_normal_fan_out_, xavier_normal_
from cvad_tpu_torch.models.layers import MaskedBatchNorm
from cvad_tpu_torch.ops.attention import TemporalAttentionEncoder
from cvad_tpu_torch.ops.pallas_kernels import memory_min_cosine_distance


class MemoryBankState(NamedTuple):
    """Ring buffer of normal sequence features."""

    memory: torch.Tensor  # (M, D) float32
    ptr: torch.Tensor     # () int32: the next slot to write
    fill: torch.Tensor    # () int32: the number of valid slots (<= M)


def init_memory(size: int, dim: int, device=None) -> MemoryBankState:
    return MemoryBankState(
        memory=torch.zeros((size, dim), dtype=torch.float32, device=device),
        ptr=torch.zeros((), dtype=torch.int32, device=device),
        fill=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def update_memory(state: MemoryBankState, feats: torch.Tensor
                  ) -> MemoryBankState:
    """FIFO write of every row of `feats` with wraparound (the reference's
    ``update_memory``, ``:201-219``); a new state, no host sync.  Rows
    beyond M in one call would land on one slot twice: B <= M."""
    m, b = state.memory.shape[0], feats.shape[0]
    idx = (state.ptr + torch.arange(b, dtype=torch.int32,
                                    device=feats.device)) % m
    memory = state.memory.index_copy(0, idx.long(),
                                     feats.detach().to(state.memory.dtype))
    return MemoryBankState(memory, (state.ptr + b) % m,
                           torch.clamp(state.fill + b, max=m))


def memory_anomaly_score(state: MemoryBankState, feats: torch.Tensor,
                         min_fill: int = 10) -> torch.Tensor:
    """Min cosine distance to the filled slots, scaled to [0, 1] (K3), and 0
    for every row until `min_fill` slots are filled: a device-side select,
    no host read of the fill."""
    score = memory_min_cosine_distance(feats, state.memory, state.fill)
    return torch.where(state.fill >= min_fill, score,
                       torch.zeros_like(score))


def _conv(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d or ConvTranspose2d in x's dtype (parameters stay float32)."""
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, layer.stride, layer.padding)
    return F.conv2d(x, w, b, layer.stride, layer.padding)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class _LSTM(nn.Module):
    """One-layer LSTM with flax's arithmetic and one bias per gate (see the
    module docstring); torch's parameter names."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(4 * hidden))
        self.register_buffer("bias_hh_l0", torch.zeros(4 * hidden))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's defaults: lecun-normal input kernels, orthogonal recurrent
        kernels, per gate; zero biases."""
        h, i = self.hidden, self.weight_ih_l0.shape[1]
        std = (1.0 / i) ** 0.5 / 0.87962566103423978  # truncated at 2 std
        for g in range(4):
            rows = slice(g * h, (g + 1) * h)
            block = torch.empty(i, h)
            nn.init.trunc_normal_(block, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            self.weight_ih_l0[rows] = block.T
            rec = torch.empty(h, h)
            nn.init.orthogonal_(rec, generator=gen)
            self.weight_hh_l0[rows] = rec.T
        self.bias_ih_l0.zero_()
        self.bias_hh_l0.zero_()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a reference state dict has two biases: hold their sum
        ih, hh = prefix + "bias_ih_l0", prefix + "bias_hh_l0"
        if ih in state_dict and hh in state_dict:
            state_dict = dict(state_dict)
            state_dict[ih] = state_dict[ih] + state_dict[hh]
            state_dict[hh] = torch.zeros_like(state_dict[hh])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T, I) -> the last hidden state (B, H)."""
        b, t, _ = z.shape
        h = z.new_zeros((b, self.hidden))
        c = z.new_zeros((b, self.hidden))
        xw = (z.reshape(b * t, -1) @ self.weight_ih_l0.T).reshape(b, t, -1)
        w_hh = self.weight_hh_l0.T
        for s in range(t):
            gates = xw[:, s] + (h @ w_hh + self.bias_ih_l0)
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h


class MemoryVideoAutoEncoder(nn.Module):
    """Clips (B, T, C, H, W) -> dict of reconstruction, features and memory
    scores (`cvad_tpu`'s `MemoryVideoAutoEncoder`).  BatchNorm runs on batch
    statistics in ``train()`` mode and on running ones in ``eval()``.
    Updating the bank is the train step's job (`update_memory_masked`)."""

    def __init__(self, cfg: Optional[FamilyBConfig] = None, seed: int = 0):
        super().__init__()
        cfg = cfg or FamilyBConfig()
        self.cfg = cfg
        # the layers' default initialisation would draw from the global
        # generator; `reset_parameters` draws everything from `seed`
        with torch.random.fork_rng(devices=[]):
            self._build(cfg)
        self.reset_parameters(seed)

    def _build(self, cfg: FamilyBConfig) -> None:
        ch = cfg.conv_channels
        slope = cfg.leaky_slope
        layers = []
        c_in = cfg.in_channels
        for c in ch:
            layers += [nn.Conv2d(c_in, c, 4, 2, 1), MaskedBatchNorm(c),
                       nn.LeakyReLU(slope)]
            c_in = c
        layers += [nn.Flatten(), nn.Linear(ch[-1] * 4 * 4, cfg.latent_dim),
                   nn.Tanh()]
        self.encoder = nn.Sequential(*layers)
        layers = [nn.Linear(cfg.latent_dim, ch[-1] * 4 * 4),
                  nn.LeakyReLU(slope), nn.Unflatten(1, (ch[-1], 4, 4))]
        c_in = ch[-1]
        for c in (ch[2], ch[1], ch[0]):
            layers += [nn.ConvTranspose2d(c_in, c, 4, 2, 1),
                       MaskedBatchNorm(c), nn.LeakyReLU(slope)]
            c_in = c
        layers += [nn.ConvTranspose2d(c_in, cfg.in_channels, 4, 2, 1),
                   nn.Sigmoid()]
        self.decoder = nn.Sequential(*layers)
        if cfg.temporal_encoder == "attention":
            self.temporal = TemporalAttentionEncoder(
                cfg.latent_dim, num_layers=cfg.attn_layers,
                num_heads=cfg.attn_heads)
            width = cfg.latent_dim
        else:
            self.temporal_encoder = _LSTM(cfg.latent_dim, cfg.lstm_hidden)
            width = cfg.lstm_hidden
        self.register_buffer("normal_memory", torch.zeros(
            cfg.memory_size, width))
        self.register_buffer("memory_ptr", torch.zeros(1, dtype=torch.long))
        self.register_buffer("memory_fill", torch.zeros(1, dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """The reference's scheme for the encoder and decoder, then the
        temporal encoder's own (flax's defaults, as `cvad_tpu` initialises
        them), from a `torch.Generator` seeded with `seed`, drawn on the CPU
        in module order."""
        gen = torch.Generator().manual_seed(int(seed))
        for mod in (*self.encoder, *self.decoder):
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = torch.empty(mod.weight.shape)
                mod.weight.copy_(kaiming_normal_fan_out_(w, gen))
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                w = torch.empty(mod.weight.shape)
                mod.weight.copy_(xavier_normal_(w, gen, gain=0.5))
                mod.bias.zero_()
        self._temporal().reset_parameters(gen)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)
        key = prefix + "memory_fill"
        if key not in state_dict:  # a reference state dict: fill = ptr
            if key in missing_keys:
                missing_keys.remove(key)
            with torch.no_grad():
                self.memory_fill.copy_(self.memory_ptr)

    # -- memory bank ---------------------------------------------------------

    def memory_bank(self) -> MemoryBankState:
        """The bank in the buffers as a `MemoryBankState` (int32 counts on
        the model's device)."""
        return MemoryBankState(self.normal_memory,
                               self.memory_ptr.reshape(()).to(torch.int32),
                               self.memory_fill.reshape(()).to(torch.int32))

    @torch.no_grad()
    def set_memory_bank(self, state: MemoryBankState) -> None:
        self.normal_memory.copy_(state.memory)
        self.memory_ptr.copy_(state.ptr.reshape(1))
        self.memory_fill.copy_(state.fill.reshape(1))

    # -- forward -------------------------------------------------------------

    def _run(self, seq: nn.Sequential, x: torch.Tensor,
             valid: Optional[torch.Tensor]) -> torch.Tensor:
        for layer in seq:
            if isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
                x = _conv(layer, x)
            elif isinstance(layer, nn.Linear):
                x = _dense(layer, x)
            elif isinstance(layer, MaskedBatchNorm):
                x = layer(x, valid=valid)
            else:
                x = layer(x)
        return x

    def _temporal(self) -> nn.Module:
        """The temporal encoder: (B, T, latent) -> (B, width) float32."""
        if self.cfg.temporal_encoder == "attention":
            return self.temporal
        return self.temporal_encoder

    def _dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def encode_frames(self, flat: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, C, H, W) frames -> (N, latent) float32 latents."""
        return self._run(self.encoder, flat.to(self._dtype()),
                         valid).float()

    def decode(self, seq: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, D) sequence features -> (B, C, H, W) float32 frames."""
        return self._run(self.decoder, seq.to(self._dtype()), valid).float()

    def encode_sequence(self, frames: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, C, H, W) -> (sequence feature (B, D), frame features
        (B, T, D))."""
        b, t = frames.shape[:2]
        fvalid = None if valid is None else valid.repeat_interleave(t)
        z = self.encode_frames(frames.reshape((b * t,) + frames.shape[2:]),
                               fvalid).reshape(b, t, -1)
        return self._temporal()(z), z

    def folded_forward(self, flat: torch.Tensor,
                       memory: Optional[MemoryBankState], *, t: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """The train path's forward over pre-folded frames (B*T, C, H, W):
        the same math as `forward` without the broadcast reconstruction.
        With ``memory=None`` the memory score is not computed (the train
        step reads none)."""
        b = flat.shape[0] // t
        fvalid = None if valid is None else valid.repeat_interleave(t)
        z = self.encode_frames(flat, fvalid).reshape(b, t, -1)
        seq = self._temporal()(z)
        out = {"recon_frame": self.decode(seq, valid),
               "sequence_feature": seq, "frame_features": z}
        if memory is not None:
            out["anomaly_score"] = memory_anomaly_score(
                memory, seq, self.cfg.memory_min_fill)
        return out

    def forward(self, frames: torch.Tensor,
                memory: Optional[MemoryBankState] = None,
                valid: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """(B, T, C, H, W) clips; `memory` defaults to the model's bank."""
        if memory is None:
            memory = self.memory_bank()
        seq, per_frame = self.encode_sequence(frames, valid)
        frame = self.decode(seq, valid)
        recon = frame[:, None].expand((frame.shape[0], frames.shape[1])
                                      + frame.shape[1:])
        return {"reconstructed": recon, "sequence_feature": seq,
                "frame_features": per_frame,
                "anomaly_score": memory_anomaly_score(
                    memory, seq, self.cfg.memory_min_fill)}
