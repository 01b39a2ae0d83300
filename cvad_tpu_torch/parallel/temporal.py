"""Clips sharded along T over the mesh's time axis: family D's halo
forward, and the sharded forwards of families C, B and A.

`cvad_tpu`'s Trainer shards the clips' T axis for every family when the
mesh has a time axis and lets GSPMD insert the halos and gathers
(`cvad_tpu/train/engine.py:89-124`); a (d x t) step is the one-rank step
of the same global batch.  Here each cross-rank dependence is one of
`collectives`' autograd Functions, so that the gradient accounting of
that module holds: a tensor computed from a rank's own frames carries
N = d * t times its true gradient, a tensor replicated over the time axis
(everything after a gather along T) N_data times it.

BatchNorm: a `MaskedBatchNorm` that sees a rank's own frames sums its
count, sum and sum of squares over every rank (the mesh's ``frames``
axis: data and time); one behind the gather along T sees the same rows on
every rank of a time group and sums over ``data`` alone (its ``axis``,
`collectives.bind_batchnorm`), or its count would be t times too large.
Random draws: every draw of families C, B and A is made after the gather
along T (C's classifier dropout, A's detector and head dropout and VAE
draw; B draws nothing), at the global batch's rows through
`collectives.RowDraws`, so a sharded step takes the one-rank step's
draws.

- **D** (`sharded_forward`): port of `cvad_tpu/parallel/temporal.py`
  (:35-133), below.
- **C** (`sharded_forward_c`): each of the first `c_local_blocks` conv
  blocks takes a (1, 1) halo along T and runs on the rank's frames (a
  max pool needs a local T its kernel divides, so the shards stay
  aligned with the global pools); that block's output is gathered along
  T and the rest (the other blocks, the global average pool, the
  classifier) runs replicated.  At t = 4 and T = 8 block 3's local T
  would be 1/2: blocks 1-2 run locally, block 3 replicated.
- **B** (`sharded_sequence_b`): the frame encoder runs on the rank's
  frames, the latents are gathered along T (dim 1) before the temporal
  encoder (the LSTM, or attention with K6 over the full T), which, the
  decoder, the bank score and the bank write then run alike on every
  time rank; the train step's data-side moments and the eval step's
  reconstruction error sum over the time group (`train/tasks.py`).
- **A** (`sharded_forward_a`): the backbone runs on the rank's frames
  (``remat`` as in the model), its features are gathered along T before
  the detector, so the tracker and everything after it see the whole
  clip, replicated over time.

Which (T, t) pairs run: `time_shards_valid`.

The train tasks of C, B and A take these forwards at every size of the
time axis: without one each collective over it is the identity and the
``frames`` axis holds the data axis's ranks, so the forward is the
model's own.  Family D keeps its one-rank forward beside `sharded_forward`:
that one runs conv1 through K1 (`models/layers.py::TFoldConv1`), the
halo forward through ``F.conv3d``.

Family D: each rank of a time group holds T / t frames of its rows'
clips; the three convs (k = 3, pad 1 along T) take one neighbour frame on
each side at stride 1 and one on the left at stride 2
(`collectives.halo_exchange`, zeros at the ends: the global zero
padding), and run as ``F.conv3d`` with no T padding, as
`cvad_tpu` runs ``lax.conv_general_dilated`` there (no Pallas kernel, so
no K1).  conv3's small output is gathered along T over the time group, so
the adaptive pool and the heads see the whole clip, alike on every rank of
the group.  The gradient flows back through the gather and the halos
(`collectives`: each carries the sum over the ranks), so the trainer runs
family D's train step through `sharded_forward` when
``parallel.temporal_axis`` > 1 (`train/tasks.py`).

Halo rules for k = 3, pad 1: stride 1 takes (left 1, right 1), stride 2
takes (left 1, right 0); a local T that is a multiple of 4 keeps both
stride-2 convs aligned with the global ones (`temporal_shards_valid`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cvad_tpu_torch.models.family_c import POOLS
from cvad_tpu_torch.models.family_d import (CausalAnomalyDetector,
                                            CompactFeatureExtractor, pool3d)
from cvad_tpu_torch.models.layers import (accumulate, compute_dtype, dropout,
                                          max_pool3d, run_seq)
from cvad_tpu_torch.parallel.collectives import gather, halo_exchange
from cvad_tpu_torch.runtime.mesh import Axis, Mesh, shard_batch


def temporal_shards_valid(t: int, n_time: int) -> bool:
    """Global T splits evenly and each local shard stays stride-even
    through both stride-2 convs."""
    return t % n_time == 0 and (t // n_time) % 4 == 0


def time_shards_valid(family: str, t: int, n_time: int) -> bool:
    """Whether family `family`'s clips of T = `t` frames shard over
    `n_time` time ranks: T splits evenly over them, and

    - D: each local shard a multiple of 4 (`temporal_shards_valid`);
    - C: T >= 4, the one-rank model's own need (its two T pools);
      `c_local_blocks` picks where the gather goes for any local T;
    - B, A: nothing more (per-frame encoders, gathered before anything
      that reads across frames)."""
    if family == "d":
        return temporal_shards_valid(t, n_time)
    if t % n_time:
        return False
    return t >= 4 if family == "c" else True


def check_time_shards(family: str, t: int, n_time: int) -> None:
    """Raise `ValueError` where `time_shards_valid` says no."""
    if not time_shards_valid(family, t, n_time):
        need = {"d": f"T % ({n_time} * 4) == 0",
                "c": f"T % {n_time} == 0 and T >= 4"}.get(
                    family, f"T % {n_time} == 0")
        raise ValueError(
            f"family {family.upper()}: T={t} does not shard over "
            f"parallel.temporal_axis={n_time} time ranks (need {need})")


def _conv_block(conv, x: torch.Tensor, t_stride: int, axis: Axis
                ) -> torch.Tensor:
    """One conv (its bias, ReLU) over this rank's frames plus the halo,
    spatially padded as the model's conv."""
    left, right = (1, 1) if t_stride == 1 else (1, 0)
    x = halo_exchange(x, axis, left, right, dim=2)
    y = F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                 stride=(t_stride, 2, 2), padding=(0, 1, 1))
    return F.relu(y)


def sharded_features(fe: CompactFeatureExtractor, x: torch.Tensor,
                     axis: Axis, generator=None) -> torch.Tensor:
    """`fe`'s features of this rank's rows from its frames `x` (b, C,
    T / t, H, W): the convs with halos, conv3's output gathered along T,
    the pool, ``fc`` and dropout (in ``fe.training``, from `generator`)."""
    heads = fe.fc.weight.dtype
    x = x.to(fe.dtype if fe.dtype == torch.bfloat16 else heads)
    for conv, stride in ((fe.conv3d_1, 1), (fe.conv3d_2, 2),
                         (fe.conv3d_3, 2)):
        x = _conv_block(conv, x, stride, axis)
    x = pool3d(gather(x, axis, dim=2), fe.pool_out)
    x = x.reshape(x.shape[0], -1)
    x = F.linear(x, fe.fc.weight.to(x.dtype), fe.fc.bias.to(x.dtype))
    return dropout(x, fe.p, fe.training, generator).to(heads)


def sharded_forward(model: CausalAnomalyDetector, x: torch.Tensor,
                    mesh: Mesh, generator=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The model's (scores, adjacency, features) of this rank's rows from
    its frames `x` (b, C, T / t, H, W), in the model's mode."""
    if x.shape[2] % 4:
        raise ValueError(f"a local T of {x.shape[2]} frames breaks the "
                         "stride-2 convs' alignment: T must be a multiple "
                         f"of 4 x {mesh.time.size} (the time axis)")
    feats = sharded_features(model.feature_extractor, x, mesh.time,
                             generator)
    return model.heads(feats, generator)


def temporal_sharded_forward(model: CausalAnomalyDetector, clips,
                             mesh: Mesh, device: Optional[torch.device] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The family-D forward of a global batch of clips (B, T, H, W, C) in
    [0, 1] (numpy or a tensor), rows over the data axis and frames over
    the time axis: (scores (B, 1), adjacency (B, N, N), features (B, D))
    of the whole batch, gathered on every rank.  Evaluation semantics come
    from the model's mode (`cvad_tpu`'s is deterministic); autograd flows
    through it.  Raises `ValueError` where T does not shard."""
    t = clips.shape[1]
    if not temporal_shards_valid(t, mesh.time.size):
        raise ValueError(f"T={t} not shardable over {mesh.time.size} time "
                         f"ranks (need T % ({mesh.time.size} * 4) == 0)")
    dev = device or next(model.parameters()).device
    local = shard_batch(mesh, {"clips": clips}, time_dim=1)["clips"]
    x = torch.as_tensor(local).to(dev, torch.float32).permute(0, 4, 1, 2, 3)
    s, adj, f = sharded_forward(model, x, mesh)
    return tuple(gather(o, mesh.data) for o in (s, adj, f))


def c_local_blocks(t_local: int) -> int:
    """How many of family C's conv blocks run on a time rank's own frames:
    block i does while its pool's T kernel divides the local T entering
    it (`POOLS`: 1, 2, 2), so that each local pool covers the global
    pool's windows.  Always at least 1 (its T kernel is 1)."""
    k = 0
    for pool in POOLS:
        if t_local % pool[0]:
            break
        t_local //= pool[0]
        k += 1
    return k


def sharded_forward_c(model, x: torch.Tensor, mesh: Mesh, generator=None,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Family C's scores (b, 1) of this rank's rows from its frames `x`
    (b, C, T / t, H, W), in the model's mode: the first `c_local_blocks`
    blocks on the frames (a (1, 1) halo a conv, BatchNorm over the mesh's
    ``frames``), their output gathered along T, the rest replicated
    (BatchNorm over ``data``); the classifier's dropout from
    `generator`."""
    check_time_shards("c", x.shape[2] * mesh.time.size, mesh.time.size)
    dtype = compute_dtype(model.cfg.dtype, model.classifier[1].weight)
    x = x.to(dtype)
    layers = list(model.features)
    k = c_local_blocks(x.shape[2])
    for i in range(len(POOLS)):
        conv, bn, act, pool = layers[4 * i:4 * i + 4]
        w, b = conv.weight.to(dtype), conv.bias.to(dtype)
        if i < k:
            x = halo_exchange(x, mesh.time, 1, 1, dim=2)
            x = F.conv3d(x, w, b, padding=(0, 1, 1))
            x = bn(x, valid=valid, axis=mesh.frames)
        else:
            x = bn(F.conv3d(x, w, b, padding=1), valid=valid)
        x = max_pool3d(act(x), pool.kernel_size)
        if i == k - 1:
            x = gather(x, mesh.time, dim=2)
    x = accumulate(x).mean((2, 3, 4))
    return run_seq(model.classifier, x, model.training, generator)


def sharded_sequence_b(model, x: torch.Tensor, mesh: Mesh,
                       valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Family B's sequence features (b, D) of this rank's rows from its
    frames `x` (b, T / t, C, H, W), in the model's mode: the frame encoder
    on the frames (BatchNorm over the mesh's ``frames``), the latents
    gathered along T, the temporal encoder over the whole clip, alike on
    every rank of the time group."""
    b, t = x.shape[:2]
    check_time_shards("b", t * mesh.time.size, mesh.time.size)
    fvalid = None if valid is None else valid.repeat_interleave(t)
    z = model.encode_frames(x.reshape((b * t,) + x.shape[2:]), fvalid,
                            axis=mesh.frames).reshape(b, t, -1)
    return model._temporal()(gather(z, mesh.time, dim=1))


def sharded_forward_a(model, frames: torch.Tensor, mesh: Mesh,
                      generator=None, valid: Optional[torch.Tensor] = None
                      ) -> dict:
    """Family A's outputs (the model's dict) for this rank's rows from its
    frames (b, T / t, C, H, W), in the model's mode: the backbone on the
    frames (BatchNorm over the mesh's ``frames``), its features gathered
    along T, every later stage (`CausalPipelineDetector.heads`) over the
    whole clip, replicated over time; draws from `generator`."""
    check_time_shards("a", frames.shape[1] * mesh.time.size,
                      mesh.time.size)
    feats = model.features(frames, valid, axis=mesh.frames)
    return model.heads(gather(feats, mesh.time, dim=1), generator)
