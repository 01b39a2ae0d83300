"""Multi-process start-up and input sharding.

Port of `cvad_tpu/runtime/multihost.py` (:37-193):

1. `initialize` starts the ``torch.distributed`` process group from the
   environment (`cvad_tpu`'s ``CVAD_COORDINATOR`` / ``CVAD_NUM_PROCESSES``
   / ``CVAD_PROCESS_ID``, or torchrun's ``RANK`` / ``WORLD_SIZE`` /
   ``MASTER_ADDR`` / ``MASTER_PORT`` / ``LOCAL_RANK``); it is idempotent
   and a no-op for one process.  The backend follows the device: NCCL for
   a CUDA device (``cuda:LOCAL_RANK``), gloo for the CPU (`start_group`);
   nothing falls back from one to the other;
2. `HostShardDataset` is a view of this process's `host_local_slice` of a
   globally indexed dataset, index protocols (``get_uint8``,
   ``warm_frames``) translated;
3. `make_host_loader` is a `BatchLoader` over that shard with this
   process's share of the global batch, capped at the fleet-wide step
   count, so that no rank runs a collective alone;
4. `form_global_batch`: in torch each rank's local batch already is its
   shard of the global one, so this puts it on the rank's device with its
   ``valid`` mask and checks that every rank holds as many rows (the
   gathers along the data axis need equal parts).

Steps 2 and 3 are host logic, tested with explicit ``process_index`` /
``process_count`` against `cvad_tpu`'s.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from cvad_tpu_torch.runtime.mesh import Mesh, host_local_slice


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """The process group's layout after `initialize` (one device a
    process)."""

    process_index: int
    process_count: int
    local_devices: int
    global_devices: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def _info() -> ProcessInfo:
    if dist.is_available() and dist.is_initialized():
        return ProcessInfo(dist.get_rank(), dist.get_world_size(), 1,
                           dist.get_world_size())
    return ProcessInfo(0, 1, 1, 1)


def start_group(rank: int, world_size: int, init_method: str,
                device: Union[str, torch.device],
                timeout_s: float = 600.0) -> None:
    """Start the process group: NCCL where `device` is a CUDA device (set
    as the current one, and bound to the group), gloo where it is the
    CPU.  Collectives that wait longer than `timeout_s` raise."""
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> ProcessInfo:
    """Start the process group of a multi-process run.

    The arguments default to ``CVAD_COORDINATOR`` (host:port, a
    ``tcp://`` rendezvous), ``CVAD_NUM_PROCESSES`` and ``CVAD_PROCESS_ID``,
    else to torchrun's ``WORLD_SIZE`` and ``RANK`` with its rendezvous
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``).  One process
    (nothing set, or a count of 1) starts nothing.  A second call returns
    the running group's layout.  `device` None means this process's card,
    ``cuda:LOCAL_RANK`` (NCCL); ``'cpu'`` runs gloo."""
    if dist.is_available() and dist.is_initialized():
        return _info()
    env = os.environ
    coordinator_address = coordinator_address or env.get("CVAD_COORDINATOR")
    if num_processes is None:
        n = env.get("CVAD_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("CVAD_PROCESS_ID") or env.get("RANK")
        process_id = int(r) if r else None
    if num_processes is None or num_processes <= 1:
        return _info()
    # torchrun's workers join its rendezvous store through env://
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://" if "MASTER_ADDR" in env else None)
    if init is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address and a process id (CVAD_COORDINATOR, "
                         "CVAD_PROCESS_ID; or torchrun's)")
    local = int(env.get("LOCAL_RANK", "0"))
    dev = torch.device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(f"cuda:{local}")
    start_group(process_id, num_processes, init, dev)
    return _info()


class HostShardDataset:
    """View of a map-style dataset restricted to this process's slice of
    its global index space (`host_local_slice`)."""

    def __init__(self, dataset, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        sl = host_local_slice(len(dataset), process_index, process_count)
        self._offset = sl.start
        self._length = sl.stop - sl.start

    def __len__(self) -> int:
        return self._length

    def __getitem__(self, idx: int):
        if not 0 <= idx < self._length:
            raise IndexError(idx)
        return self.dataset[self._offset + idx]

    def __getattr__(self, name):
        # the index-taking protocols translate shard-local indices to the
        # inner dataset's global ones (a bare passthrough would hand every
        # process beyond the first shard 0's clips); defined here, not as
        # methods, so hasattr() still tells whether the inner dataset has
        # them
        if name == "get_uint8":
            inner = getattr(self.dataset, name)
            offset, length = self._offset, self._length

            def get_uint8(idx):
                if not 0 <= idx < length:
                    raise IndexError(idx)
                return inner(offset + idx)
            return get_uint8
        if name == "warm_frames":
            inner = getattr(self.dataset, name)
            offset = self._offset
            return lambda indices: inner([offset + int(i) for i in indices])
        return getattr(self.dataset, name)


def per_host_batch_size(global_batch: int,
                        process_count: Optional[int] = None,
                        process_index: Optional[int] = None) -> int:
    """This process's share of the global batch (the remainder goes to
    process 0)."""
    pc = _info().process_count if process_count is None else process_count
    pi = _info().process_index if process_index is None else process_index
    per = global_batch // pc
    if pi == 0:
        per += global_batch % pc
    return per


def make_host_loader(dataset, global_batch: int, *,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None,
                     **loader_kwargs):
    """A `BatchLoader` over this process's shard of `dataset`, yielding its
    `per_host_batch_size` share of each global batch.  ``drop_last`` and a
    cap at the fleet-wide least step count are forced: shard sizes differ
    (the dataset's remainder goes to the last process) and so do local
    batch sizes (the batch's remainder goes to process 0), and a rank that
    ran a step alone would wait in its collectives.  Every process computes
    the same least count from the slice and batch formulas.  The loader is
    marked ``host_local``: the trainer takes its batches as this rank's
    rows, and the device clip cache does not hold them."""
    from cvad_tpu_torch.data.batcher import BatchLoader

    pc = _info().process_count if process_count is None else process_count
    n = len(dataset)
    common_steps = min(
        (host_local_slice(n, i, pc).stop - host_local_slice(n, i, pc).start)
        // max(per_host_batch_size(global_batch, pc, i), 1)
        for i in range(pc))
    shard = HostShardDataset(dataset, process_index, process_count)
    local_bs = per_host_batch_size(global_batch, process_count, process_index)
    loader_kwargs.setdefault("num_threads", 4)
    loader_kwargs["drop_last"] = True
    loader_kwargs["max_batches"] = common_steps
    loader = BatchLoader(shard, local_bs, **loader_kwargs)
    loader.host_local, loader.global_batch = True, global_batch
    return loader


def form_global_batch(mesh: Mesh, local_batch: Mapping[str, np.ndarray],
                      device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch (`make_host_loader`'s batch) on
    its device with the all-ones ``valid`` mask, once every rank of the
    data axis is known to hold as many rows (one gather of the counts;
    `ValueError` otherwise): the sharded step's input, as `cvad_tpu`'s
    ``make_array_from_process_local_data`` assembles it."""
    from cvad_tpu_torch.parallel.collectives import gather
    from cvad_tpu_torch.runtime.device import resolve_device

    dev = resolve_device(device)
    n = len(next(iter(local_batch.values())))
    counts = gather(torch.tensor([n], device=dev), mesh.data)
    if bool((counts != n).any()):
        raise ValueError(f"ranks hold {counts.tolist()} rows of one global "
                         "batch; a sharded step needs equal parts (pick a "
                         "global batch that the process count divides)")
    batch = {**local_batch, "valid": np.ones(n, np.float32)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
