"""Batching host feed.

Port of `cvad_tpu/data/batcher.py::BatchLoader` (:20-175): the same
``default_rng(seed + epoch)`` shuffle, ``set_epoch``, ``iter_from``,
``sample_batch`` and uint8 transfer, so the batch order is identical to
`cvad_tpu`'s.  A producer thread collates batches into a bounded queue.
`DevicePrefetcher` (pinned staging on a side stream) is not ported yet
(ROADMAP Queue 1 item 15): the trainer copies each batch with a plain
``.to(device)``.  Before collating a batch it calls the dataset's
``warm_frames`` where it has one (the frame-folder datasets: one threaded
native decode of every frame the batch still misses), and
``torch_layout`` collates (B, C, T, H, W) for the reference-layout adapter
(`data/datasets.py::create_avenue_dataloaders`).  The knobs of the
multi-host path (``max_batches``) and the device clip cache
(``epoch_index_batches``) wait for their ports.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class BatchLoader:
    """Iterable over collated host batches ``{"clips": (B,T,H,W,C), "labels": (B,)}``.

    Items are collated in a small thread pool; batches come out in
    deterministic order, the epoch's shuffle from
    ``default_rng(seed + epoch)`` as in `cvad_tpu`.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 torch_layout: bool = False, num_threads: int = 4,
                 prefetch: int = 2, transfer_dtype: str = "float32"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.torch_layout = torch_layout
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        # uint8 transfer: 4x fewer host->device bytes; the train step
        # normalises on the device (cvad_tpu_torch.train.tasks.prep_clips)
        self.transfer_dtype = transfer_dtype
        self._epoch = 0
        self._executor = None

    def _pool(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=self.num_threads)
        return self._executor

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else (n + self.batch_size - 1) // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield idx[s:s + self.batch_size]

    def _collate(self, indices) -> Dict[str, np.ndarray]:
        if hasattr(self.dataset, "warm_frames"):
            # one threaded native decode of all the batch's missing frames:
            # overlapping windows share frames, which the per-item pool
            # below would decode once a window
            self.dataset.warm_frames([int(i) for i in indices])
        use_u8 = (self.transfer_dtype == "uint8"
                  and hasattr(self.dataset, "get_uint8"))
        get = self.dataset.get_uint8 if use_u8 else self.dataset.__getitem__
        if self.num_threads > 1 and len(indices) > 1:
            items = list(self._pool().map(lambda i: get(int(i)), indices))
        else:
            items = [get(int(i)) for i in indices]
        clips = np.stack([c for c, _ in items])
        labels = np.asarray([l for _, l in items], np.float32)
        if self.torch_layout:  # (B, T, H, W, C) -> (B, C, T, H, W)
            clips = np.transpose(clips, (0, 4, 1, 2, 3))
        return {"clips": clips, "labels": labels}

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """First batch in dataset order WITHOUT starting an epoch: no
        producer thread to strand, no shuffle-epoch increment — for
        model/state initialization (engine ``fit``)."""
        n = min(self.batch_size, len(self.dataset))
        return self._collate(np.arange(n))

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch: the NEXT iteration uses ``seed + epoch``'s
        permutation.  The trainer ties shuffle order to the global training
        epoch so a resumed run replays the interrupted run's batch order
        exactly (torch ``DistributedSampler.set_epoch`` analog)."""
        self._epoch = epoch - 1

    def iter_from(self, skip: int) -> Iterator[Dict[str, np.ndarray]]:
        """This epoch's iterator starting at batch index ``skip`` — identical
        shuffle, skipped batches never decoded (mid-epoch resume)."""
        return self._iter(skip)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._iter(0)

    def _iter(self, skip: int) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        batches = list(self._batch_indices())[skip:]
        if not batches:
            return iter(())
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []
        cancel = threading.Event()  # set when the consumer abandons the epoch

        def _put(item) -> bool:
            # bounded-queue put that gives up once cancelled, so an abandoned
            # iterator can never strand its producer thread on q.put forever
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if not _put(self._collate(b)):
                        return  # consumer gone: stop decoding
            except BaseException as e:  # surface to the consumer: a silently
                err.append(e)           # truncated epoch would corrupt
            finally:                    # metrics/schedule/checkpoints
                _put(sentinel)

        def gen():
            # start the producer HERE, not in _iter: a generator that is
            # created but never advanced never runs its finally (close() is
            # a no-op on an unstarted generator), so a thread started
            # eagerly could never be cancelled
            threading.Thread(target=producer, daemon=True).start()
            try:
                while True:
                    item = q.get()
                    if item is sentinel:
                        if err:
                            raise RuntimeError(
                                "BatchLoader producer failed mid-epoch"
                            ) from err[0]
                        break
                    yield item
            finally:
                cancel.set()  # normal end OR abandoned mid-epoch (gen.close)

        return gen()
