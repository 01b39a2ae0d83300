"""Family D's clips sharded along T over the mesh's time axis, with a halo
exchange for the temporal convs.

Port of `cvad_tpu/parallel/temporal.py` (:35-133).  Each rank of a time
group holds T / t frames of its rows' clips; the three convs (k = 3, pad 1
along T) take one neighbour frame on each side at stride 1 and one on the
left at stride 2 (`collectives.halo_exchange`, zeros at the ends: the
global zero padding), and run as ``F.conv3d`` with no T padding, as
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

from cvad_tpu_torch.models.family_d import (CausalAnomalyDetector,
                                            CompactFeatureExtractor, pool3d)
from cvad_tpu_torch.models.layers import dropout
from cvad_tpu_torch.parallel.collectives import gather, halo_exchange
from cvad_tpu_torch.runtime.mesh import Axis, Mesh, shard_batch


def temporal_shards_valid(t: int, n_time: int) -> bool:
    """Global T splits evenly and each local shard stays stride-even
    through both stride-2 convs."""
    return t % n_time == 0 and (t // n_time) % 4 == 0


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
