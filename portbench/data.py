"""The benchmark's inputs, made from the run's seed: uint8 clips and their
labels drawn on the card in one call each, a dataset over them, and the
loader the trainer's device clip cache reads.

`SeededLoader` is the port's `BatchLoader` (the shuffle of each epoch from
``default_rng(seed + epoch)``), with a few set-up epochs of fixed rows: the
negative epochs ``-1, -2, ...`` give the batches `fixed` names, so that the
first steps, which the reference follows, run through the trainer's own
call and feed on rows that all differ.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def seeded_clips(torch, n: int, shape: Sequence[int], anomaly_share: float,
                 seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """(clips (n, T, H, W, C) uint8, labels (n,) float32) on the host,
    drawn on `device` from a generator seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    clips = torch.randint(0, 256, (n, *shape), generator=gen, device=device,
                          dtype=torch.uint8)
    labels = (torch.rand(n, generator=gen, device=device)
              < anomaly_share).float()
    return clips.cpu().numpy(), labels.cpu().numpy()


class ArrayClips:
    """A dataset over host arrays with the port's ``get_uint8``."""

    def __init__(self, clips: np.ndarray, labels: np.ndarray):
        self.clips, self.labels = clips, labels

    def __len__(self) -> int:
        return len(self.clips)

    def get_uint8(self, i: int):
        return self.clips[i], self.labels[i]


def seeded_loader(batch_loader_cls, dataset, batch: int, seed: int,
                  fixed: Dict[int, List[np.ndarray]]):
    """A shuffled `batch_loader_cls` (the port's `BatchLoader`) over
    `dataset` in uint8, whose set-up epochs (keys of `fixed`) give fixed
    index batches."""

    class SeededLoader(batch_loader_cls):
        def epoch_index_batches(self, epoch: int) -> List[np.ndarray]:
            if epoch in fixed:
                return [np.asarray(b) for b in fixed[epoch]]
            return super().epoch_index_batches(epoch)

    return SeededLoader(dataset, batch, shuffle=True, seed=seed,
                        transfer_dtype="uint8", num_threads=4)
