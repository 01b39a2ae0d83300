"""The device mesh of the port over a `torch.distributed` world, and the
batch helpers that go with it.

Port of `cvad_tpu/runtime/mesh.py` (`create_mesh`, `shard_batch`,
`replicated`, `host_local_slice`, `pad_to_multiple`, `pad_with_valid`).
`cvad_tpu` lays its devices out as a (data, time) grid and lets GSPMD
shard a batch over it; here each rank of the process group is one cell of
that grid, ``rank = data_index * t + time_index`` (the order of
``np.asarray(devices).reshape(d, t)``), and every cross-rank dependence of
a step goes through the port's own collectives (`parallel/collectives.py`)
over the mesh's process groups:

- ``data``: the ranks that share a time index.  Each holds its rows of
  every batch; the losses see the rows of all of them, gathered;
- ``time``: the ranks that share a data index.  Each holds its frames of
  its rows' clips (family D, `parallel/temporal.py`).

Without a process group `create_mesh` gives the trivial 1 x 1 mesh, whose
axes have no group: every collective over them is the identity and costs
nothing, so one code path serves one device and N ranks, as in `cvad_tpu`
(:44-45).  A mesh over a process group always goes through the collectives
of its data axis, also in a world of one rank (a sum over one rank is an
exact copy), so that a one-card NCCL run exercises them.  The time axis
has a group only where it spans more than one rank.

The backend is the device's: NCCL for CUDA tensors, gloo for CPU ones
(`runtime/multihost.py::start_group`).  Batches are host dicts of numpy
arrays, or device dicts of tensors; `shard_batch` slices either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh: its size, this rank's index along it, and the
    process group of the ranks along it (None: the collectives over it
    are the identity)."""

    size: int
    index: int
    group: Any = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, time) grid of ranks; ``world`` is the group of every rank
    (the gradient's all-reduce), None without a process group."""

    data: Axis
    time: Axis
    rank: int = 0
    world_size: int = 1
    world: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "time": self.time.size}

    @property
    def primary(self) -> bool:
        """Rank 0: the one that writes files."""
        return self.rank == 0

    def rows(self, local: int) -> Tuple[int, int]:
        """(rows of the global batch, the first of this rank's) for `local`
        rows a rank."""
        return local * self.data.size, self.data.index * local

    def barrier(self, device: Optional[torch.device] = None) -> None:
        """Wait for every rank (after rank 0 wrote a file); nothing without
        a process group."""
        if self.world is None:
            return
        kw = {}
        if device is not None and torch.device(device).type == "cuda":
            dev = torch.device(device)
            kw["device_ids"] = [dev.index if dev.index is not None
                                else torch.cuda.current_device()]
        dist.barrier(group=self.world, **kw)


def single_mesh() -> Mesh:
    """The trivial 1 x 1 mesh: no process group, every collective the
    identity."""
    return Mesh(Axis(1, 0), Axis(1, 0))


def create_mesh(data_axis: int = 0, temporal_axis: int = 1) -> Mesh:
    """The (data, time) mesh over the initialised process group, or the
    trivial 1 x 1 mesh without one.  ``data_axis=0`` gives the data axis
    every rank the time axis leaves.  Every rank must call it, in the same
    order as its other group creations: `dist.new_group` is collective."""
    if not (dist.is_available() and dist.is_initialized()):
        if max(1, temporal_axis) != 1 or data_axis not in (0, 1):
            raise ValueError(
                f"mesh {data_axis}x{temporal_axis} needs a process group of "
                "that many ranks; none is initialised (1 rank)")
        return single_mesh()
    n, rank = dist.get_world_size(), dist.get_rank()
    t = max(1, temporal_axis)
    if n % t:
        raise ValueError(f"temporal axis {t} does not divide {n} ranks")
    d = data_axis if data_axis > 0 else n // t
    if d * t != n:
        raise ValueError(f"mesh {d}x{t} != {n} ranks")
    di, ti = divmod(rank, t)
    world = dist.group.WORLD
    if t == 1:
        return Mesh(Axis(d, di, world), Axis(1, 0), rank, n,
                    world)
    data_group = time_group = None
    for j in range(t):  # every rank makes every group, in this order
        g = dist.new_group([i * t + j for i in range(d)])
        if j == ti:
            data_group = g
    for i in range(d):
        g = dist.new_group([i * t + j for j in range(t)])
        if i == di:
            time_group = g
    return Mesh(Axis(d, di, data_group),
                Axis(t, ti, time_group), rank, n, world)


def part(x, dim: int, axis: Axis):
    """This rank's part of `x` (numpy or a tensor) along `dim` split over
    `axis`: the `axis.index`-th of `axis.size` equal parts, a view."""
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"axis {dim} of length {n} does not split into "
                         f"{axis.size} equal parts; pad it first "
                         "(pad_with_valid)")
    size = n // axis.size
    return x[(slice(None),) * dim + (slice(axis.index * size,
                                           (axis.index + 1) * size),)]


def shard_batch(mesh: Mesh, batch: Mapping[str, Any],
                time_dim: Optional[int] = None, lead: int = 0
                ) -> Dict[str, Any]:
    """This rank's part of a batch: its rows of every leaf along axis
    `lead` (1 for a stacked (K, B, ...) chunk), and with `time_dim` its
    frames along ``lead + time_dim`` of every leaf that has that axis
    (clips); lower-rank leaves (labels, valid) shard by rows only
    (`cvad_tpu`'s :92-94).  Numpy arrays or tensors; views where they can
    be."""
    out = {}
    for k, v in batch.items():
        v = part(v, lead, mesh.data)
        if time_dim is not None and v.ndim > lead + time_dim:
            v = part(v, lead + time_dim, mesh.time)
        out[k] = v
    return out


@torch.no_grad()
def replicated(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer of `module` from rank 0, so
    the replicas start equal (`cvad_tpu`'s replicated sharding); nothing
    without a process group."""
    if mesh.world is not None:
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=mesh.world)
    return module


def host_local_slice(n_items: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> slice:
    """The slice of a globally indexed dataset this process loads:
    contiguous shards, the last taking the remainder; the whole range for
    one process.  The defaults are the process group's rank and size."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    per = n_items // pc
    start = pi * per
    end = start + per if pi < pc - 1 else n_items
    return slice(start, end)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def pad_to_multiple(batch: Mapping[str, np.ndarray], multiple: int
                    ) -> Tuple[Dict[str, np.ndarray], int]:
    """Axis 0 of every array edge-padded to a multiple of `multiple`, and
    the count of real rows."""
    if not batch:
        return dict(batch), 0
    n = len(next(iter(batch.values())))
    pad = (-n) % multiple
    if pad == 0:
        return dict(batch), n

    def _pad(x):
        x = np.asarray(x)
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), mode="edge")

    return {k: _pad(v) for k, v in batch.items()}, n


def pad_with_valid(batch: Mapping[str, np.ndarray], multiple: int
                   ) -> Dict[str, np.ndarray]:
    """`pad_to_multiple` with the ``"valid"`` float mask (1 for the real
    rows, 0 for the padding) that keeps the padded rows out of every loss
    term, BatchNorm statistic and bank write; every batch the engine feeds
    carries it (all ones where nothing is padded)."""
    padded, n = pad_to_multiple(batch, multiple)
    total = len(next(iter(padded.values())))
    return {**padded, "valid": (np.arange(total) < n).astype(np.float32)}
