"""The port's collectives: what GSPMD does implicitly in `cvad_tpu`, made
explicit for `torch.distributed`.

In `cvad_tpu` a train step over a batch sharded along ``data`` is the
one-device step on the whole batch: GSPMD computes every batch-coupled
quantity over the global batch and inserts the gradient ``psum``
(`cvad_tpu/runtime/mesh.py:6-8`).  The port's losses are coupled through
the batch (family D's mean adjacency, edge band and pairwise L1 over all
normal rows; the BatchNorm statistics of families B, C and A; family B's
bank, written in row order), so a step that averages per-rank losses, as
DDP does, computes another function.  The port's step instead:

1. runs the per-sample part of the model on this rank's rows (and, on the
   time axis, frames);
2. sends every cross-rank dependence through a collective of this module
   whose backward *sums* over the ranks: `gather` (all-gather along an
   axis; backward all-reduce-sum, then this rank's slice), `all_reduce_sum`
   (BatchNorm's count, sum and sum of squares; backward all-reduce-sum) and
   `halo_exchange` (a temporal conv's neighbour frames; backward each
   halo's gradient summed into its owner's slot);
3. computes the identical global loss on every rank from the gathered
   tensors;
4. all-reduces the flat parameter gradient (one sum, in one fixed order)
   and divides it by the world size (`reduce_gradients`) before the
   global norm, the clip and the NaN guard, so that the clip is of the
   global gradient and every rank takes the same NaN decision and the
   same update.

Why sum / N is the exact global gradient.  Let L be the global loss, which
every one of the N ranks computes identically from gathered tensors, and
call rank r's contribution to dL/dθ the sum over the paths from θ through
r's local computation to L.  On the way back every collective's backward
sums over the ranks of its axis the gradients that those ranks computed,
and each rank's upstream gradient of a gathered tensor is the same
dL/dG, so a gather's backward hands rank r exactly N_axis · dL/d(its
slice); an all-reduce's backward hands each rank the sum of its partners'
gradients, each already carrying the same factor; the halo's backward
hands each rank its neighbours' gradients of its edge frames, which carry
it too.  By induction from the loss down, every gradient a rank holds
for a tensor it computed is N_data · N_time (= N) times the true
gradient of that tensor where the tensor depends on every axis's
collectives, and N_data times it for a tensor that is replicated over the
time axis (the heads), which N_time ranks hold alike.  Summed over all N
ranks, rank r's parameter gradient therefore adds to N · Σ_r (r's
contribution) = N · dL/dθ on every path, so one all-reduce-sum over the
world divided by N is dL/dθ, the one-device gradient of the same global
batch.  With N = 1 every factor is 1 and nothing changes.

Random draws are global too: `RowDraws` draws each batch-shaped tensor
(dropout masks, the VAE noise) at the global batch's rows from the step's
generator, which every rank seeds alike, and keeps this rank's rows, so
that an N-rank step takes the one-device step's draws.

Every function counts the calls it makes into `torch.distributed`
(``.calls``, and ``.backward_calls`` for the backward's), as the kernel
wrappers count launches (`train/graphs.py::launch_counters`).  Over an
axis without a group (the trivial mesh) each is the identity and counts
nothing.  These are autograd Functions over `dist.all_gather_single` (or
`all_gather_into_tensor` where a torch predates it) and `dist.all_reduce`;
`torch.distributed.nn.functional` is not used.  A collective's backward
runs on every rank only where its output reaches the loss on every rank,
as each of the port's does (each rank's halo is a Function of its own
output for that reason): a rank that skipped one would leave the others
waiting.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from cvad_tpu_torch.runtime.mesh import Axis, Mesh


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int, index: int, dim: int):
        ctx.group, ctx.size, ctx.index, ctx.dim = group, size, index, dim
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((size * xt.shape[0],) + tuple(xt.shape[1:]))
        _all_gather(out, xt, group)
        gather.calls += 1
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.dim, 0).contiguous()
        dist.all_reduce(gt, group=ctx.group)
        gather.backward_calls += 1
        n = gt.shape[0] // ctx.size
        return (gt.narrow(0, ctx.index * n, n).movedim(0, ctx.dim),
                None, None, None, None)


def gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """`x`'s parts from every rank of `axis`, concatenated along `dim` in
    rank order (rows along ``data``, frames along ``time``).  Backward: the
    sum of every rank's gradient, then this rank's slice."""
    if axis.group is None:
        return x
    return _Gather.apply(x, axis.group, axis.size, axis.index, dim)


gather.calls = 0
gather.backward_calls = 0


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        all_reduce_sum.calls += 1
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        all_reduce_sum.backward_calls += 1
        return g, None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of `x` over the ranks of `axis`; backward the same sum of
    the gradients."""
    if axis.group is None:
        return x
    return _AllReduce.apply(x, axis.group)


all_reduce_sum.calls = 0
all_reduce_sum.backward_calls = 0


@torch.no_grad()
def reduce_gradients(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The flat parameter gradient summed over every rank and divided by
    the world size: the global batch's gradient (the module docstring)."""
    if mesh.world is None:
        return flat
    out = flat.clone()
    dist.all_reduce(out, group=mesh.world)
    reduce_gradients.calls += 1
    return out / mesh.world_size


reduce_gradients.calls = 0


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int, index: int, left: int,
                right: int, dim: int):
        ctx.args = (group, size, index, left, right, dim, x.shape[dim])
        n = x.shape[dim]
        xt = x.movedim(dim, 0)
        edge = torch.cat([xt[n - left:], xt[:right]]).contiguous()
        edges = edge.new_empty((size * edge.shape[0],) + edge.shape[1:])
        _all_gather(edges, edge, group)
        halo_exchange.calls += 1
        w = left + right
        parts = []
        if left:  # the left neighbour's last frames, zeros at the start
            j = index - 1
            parts.append(edges[j * w:j * w + left] if j >= 0
                         else torch.zeros_like(xt[:left]))
        parts.append(xt)
        if right:  # the right neighbour's first frames, zeros at the end
            j = index + 1
            parts.append(edges[j * w + left:(j + 1) * w] if j < size
                         else torch.zeros_like(xt[:right]))
        return torch.cat(parts).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        group, size, index, left, right, dim, n = ctx.args
        gt = g.movedim(dim, 0)
        w = left + right
        # each neighbour's halo gradient into its slot, summed over the
        # ranks: every rank receives the gradient of its own edge frames
        buf = gt.new_zeros((size * w,) + gt.shape[1:])
        if left and index - 1 >= 0:
            j = index - 1
            buf[j * w:j * w + left] = gt[:left]
        if right and index + 1 < size:
            j = index + 1
            buf[j * w + left:(j + 1) * w] = gt[left + n:]
        dist.all_reduce(buf, group=group)
        halo_exchange.backward_calls += 1
        gx = gt[left:left + n].clone()
        own = buf[index * w:(index + 1) * w]
        gx[n - left:] += own[:left]
        gx[:right] += own[left:]
        return (gx.movedim(0, dim),) + (None,) * 6


def halo_exchange(x: torch.Tensor, axis: Axis, left: int, right: int,
                  dim: int = 2) -> torch.Tensor:
    """`x` (this rank's frames along `dim`) with `left` frames of the left
    neighbour's end before it and `right` frames of the right neighbour's
    start after it; the shards at the ends get zeros, the global conv's
    zero padding (`cvad_tpu`'s ``ppermute``, which zero-fills).  Every rank
    contributes its edge frames to one all-gather over `axis`; the
    backward all-reduces each halo's gradient into its owner's slot, so
    every rank sends its neighbours their frames' gradients, and every
    rank takes part in that collective (also the end shards, whose zero
    halo reads nothing)."""
    if axis.group is None:
        pad = [0, 0] * (x.dim() - 1 - dim) + [left, right]
        return torch.nn.functional.pad(x, pad)
    return _Halo.apply(x, axis.group, axis.size, axis.index, left, right,
                       dim)


halo_exchange.calls = 0
halo_exchange.backward_calls = 0


class RowDraws:
    """A step's generator for a rank that holds rows [start, start + rows)
    of a global batch of `total` rows: each batch-shaped draw is made at
    the global shape and cut to this rank's rows, so the N-rank step takes
    the one-device step's draws in the same order."""

    def __init__(self, generator: Optional[torch.Generator], total: int,
                 start: int):
        self.generator = generator
        self.total = total
        self.start = start

    def draw(self, fn: Callable, shape: Sequence[int], device
             ) -> torch.Tensor:
        full = fn((self.total,) + tuple(shape[1:]),
                  generator=self.generator, device=device)
        if shape[0] == self.total:
            return full
        return full.narrow(0, self.start, shape[0])


def random(shape: Sequence[int], generator, device, normal: bool = False
           ) -> torch.Tensor:
    """``torch.rand`` (``torch.randn`` where `normal`) of `shape` from
    `generator`, a `torch.Generator` or `RowDraws` (its rows of the global
    draw)."""
    fn = torch.randn if normal else torch.rand
    if isinstance(generator, RowDraws):
        return generator.draw(fn, shape, device)
    return fn(tuple(shape), generator=generator, device=device)


def counters() -> dict:
    """Every collective's call counter: name -> (object, attribute)."""
    return {"gather": (gather, "calls"),
            "gather_backward": (gather, "backward_calls"),
            "all_reduce_sum": (all_reduce_sum, "calls"),
            "all_reduce_sum_backward": (all_reduce_sum, "backward_calls"),
            "reduce_gradients": (reduce_gradients, "calls"),
            "halo_exchange": (halo_exchange, "calls"),
            "halo_exchange_backward": (halo_exchange, "backward_calls")}


def bind_batchnorm(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Point every `MaskedBatchNorm` of `model` at the mesh's data axis:
    its train-mode statistics then sum over the ranks' rows."""
    from cvad_tpu_torch.models.layers import MaskedBatchNorm

    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.axis = mesh.data
    return model


def gather_rows(batch_value: Optional[torch.Tensor], mesh: Mesh
                ) -> Optional[torch.Tensor]:
    """A per-row batch entry (labels, valid, injected pseudo-targets) of
    every rank of the data axis, in row order; None stays None."""
    if batch_value is None:
        return None
    return gather(batch_value, mesh.data)
