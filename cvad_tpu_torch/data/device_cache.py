"""Device-resident epoch clip cache: the train split's uint8 clips held in
device memory, every epoch fed from gathers on the device.

Port of `cvad_tpu/data/device_cache.py` (`device_bytes_limit`,
`cache_eligible`, `DeviceClipCache`).  One bulk host->device copy fills the
cache; after it the host sends only each epoch's shuffled indices (one
copy an epoch), and each batch is an ``index_select`` on the device.  The
batch composition is `cvad_tpu`'s: `BatchLoader.epoch_index_batches`'
order, the ``valid`` mask of every batch, ``skip`` for a mid-epoch resume,
and equal-shaped batches grouped into (K, B, ...) chunks for the K-step
call.  Over a mesh every rank holds the whole split and gathers its rows
of each index batch padded to the data axis (`cvad_tpu`'s :90-131), and on
a time axis its frames of them.  A `make_host_loader` shard is not
eligible: its rows are this rank's alone (`cvad_tpu` gates every
multi-process run out, :46; the port gates only those shards).  A cached
epoch is bit-identical to the uncached feed
(tests/test_torch_port_cache.py).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from cvad_tpu_torch.runtime.mesh import part

_DEFAULT_BYTES_LIMIT = 4 << 30  # where the device reports no memory size


def device_bytes_limit(device=None) -> int:
    """The device's memory for the cache's budget: a CUDA card's total
    memory, else `cvad_tpu`'s 4 GiB constant."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(index).total_memory)
    return _DEFAULT_BYTES_LIMIT


def cache_eligible(loader, hbm_frac: float, device=None,
                   reserved_bytes: int = 0) -> bool:
    """True where `loader`'s dataset can feed from the cache: uint8
    transfer, a ``get_uint8`` dataset, the native (B, T, H, W, C) layout,
    ``epoch_index_batches``, not a `make_host_loader` shard, and the whole
    split plus `reserved_bytes`
    (caches the caller holds already) within `hbm_frac` of the device's
    memory."""
    ds = getattr(loader, "dataset", None)
    if ds is None or len(ds) == 0:
        return False
    if getattr(loader, "transfer_dtype", None) != "uint8":
        return False
    if getattr(loader, "torch_layout", False) or getattr(
            loader, "host_local", False):
        return False
    if not hasattr(ds, "get_uint8") or not hasattr(
            loader, "epoch_index_batches"):
        return False
    try:
        clip0 = ds.get_uint8(0)[0]
    except Exception:  # noqa: BLE001 - an undecodable dataset stays uncached
        return False
    total = len(ds) * int(np.prod(clip0.shape)) + int(reserved_bytes)
    return total <= hbm_frac * device_bytes_limit(device)


def _with_valid(idx: np.ndarray, nd: int) -> Tuple[np.ndarray, np.ndarray]:
    """Edge-pad indices to a multiple of `nd`, with the valid mask
    (`cvad_tpu`'s ``pad_with_valid``)."""
    n = len(idx)
    pad = (-n) % nd
    if pad:
        idx = np.pad(idx, (0, pad), mode="edge")
    return idx.astype(np.int64), (np.arange(n + pad) < n).astype(np.float32)


class DeviceClipCache:
    """The split as one (N, T, H, W, C) uint8 device tensor and its
    float32 labels; with a `mesh`, batches of this rank's rows (and, with
    `time_dim`, frames)."""

    def __init__(self, loader, device, mesh=None,
                 time_dim: Optional[int] = None, num_threads: int = 4):
        self.loader = loader
        self.device = torch.device(device)
        self.mesh = mesh
        self.time_dim = time_dim
        ds = loader.dataset
        n = len(ds)
        if hasattr(ds, "warm_frames"):
            ds.warm_frames(list(range(n)))
        if num_threads > 1 and n > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                items = list(pool.map(ds.get_uint8, range(n)))
        else:
            items = [ds.get_uint8(i) for i in range(n)]
        host = np.stack([c for c, _ in items])
        self.clips = torch.from_numpy(host).to(self.device)  # the one fill
        self.labels = torch.from_numpy(
            np.asarray([l for _, l in items], np.float32)).to(self.device)
        self.nbytes = host.nbytes

    def _groups(self, epoch: int, k: int, nd: int, skip: int
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(indices, valid) of each item `device_batches` yields: (K, B)
        for a chunk of K equal-shaped batches where `k` > 1 (the grouping
        of `train/engine.py::_chunk_batches`), (B,) for a single batch."""
        prepared = [_with_valid(np.asarray(b), nd) for b in
                    self.loader.epoch_index_batches(epoch)[skip:]]
        out, i = [], 0
        while i < len(prepared):
            group = prepared[i:i + 1]
            while (k > 1 and len(group) < k and i + len(group) < len(prepared)
                   and prepared[i + len(group)][0].shape
                   == group[0][0].shape):
                group.append(prepared[i + len(group)])
            if k > 1 and len(group) == k:
                out.append((np.stack([g[0] for g in group]),
                            np.stack([g[1] for g in group])))
                i += k
            else:
                out.append(prepared[i])
                i += 1
        return out

    def device_batches(self, epoch: int, k: int, nd: int = 1, skip: int = 0
                       ) -> Iterator[Dict[str, torch.Tensor]]:
        """`epoch`'s batches gathered on the device: ``clips``, ``labels``
        and ``valid``, (K, B, ...) chunks where `k` > 1, single batches
        otherwise, each padded to a multiple of `nd` rows (of the mesh's
        data axis where there is a mesh), of which this rank's;
        `skip` resumes mid-epoch at the exact batch.  The
        epoch's indices and valid masks go to the device once."""
        mesh = self.mesh
        if mesh is not None:
            nd = mesh.shape["data"]
        groups = self._groups(epoch, k, nd, skip)
        if not groups:
            return
        if mesh is not None:  # this rank's rows of each padded batch
            groups = [tuple(part(a, a.ndim - 1, mesh.data) for a in g)
                      for g in groups]
        rows, masks = (self._put(np.concatenate([g[j].ravel() for g in
                                                 groups]))
                       for j in (0, 1))
        at = 0
        for idx, _ in groups:
            r = rows[at:at + idx.size]
            clips = self.clips.index_select(0, r).view(
                idx.shape + self.clips.shape[1:])
            if self.time_dim is not None:
                clips = part(clips, idx.ndim - 1 + self.time_dim,
                             mesh.time).contiguous()
            yield {"clips": clips,
                   "labels": self.labels.index_select(0, r).view(idx.shape),
                   "valid": masks[at:at + idx.size].view(idx.shape)}
            at += idx.size

    def _put(self, host: np.ndarray) -> torch.Tensor:
        """One host array on the device, copied from pinned memory without
        blocking the host on a card."""
        t = torch.from_numpy(host)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)
