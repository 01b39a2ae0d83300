"""Datasets: UCSD Ped2 (all reference variants), Avenue, and synthetic.

Port of `cvad_tpu/data/datasets.py`: `ClipDataset` (decode on access with
the frame and clip caches, `warm_frames`, `get_uint8`), `UCSDPed2Dataset`,
`AvenueDataset`, `SyntheticClipDataset`, `build_dataset`,
`create_avenue_dataloaders` and its tuple adapter.  The same windows, labels
and decode give clips bit-identical to `cvad_tpu`'s on the same tree
(tests/test_torch_port_data.py).  Frames decode on the host through the
port's build of ``native/decoder.cpp`` where it reads the format, else cv2
or PIL (`data/decode.py`); a host without any of them decodes only
``.npy`` frames.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from cvad_tpu_torch.config import DataConfig
from cvad_tpu_torch.data import decode
from cvad_tpu_torch.data.frames import (ClipSpec, clip_windows,
                                        scan_video_folders)
from cvad_tpu_torch.data.labels import assign_labels
from cvad_tpu_torch.data.synthetic import make_synthetic_clips


class ClipDataset:
    """Frame-folder clip dataset: decode-on-access with optional memoization.

    With ``cfg.cache_decoded`` (default), each FRAME is decoded once and kept
    as resized uint8 in RAM (4x smaller than f32); clips assemble from cached
    frames.  Frame-level (rather than clip-level) memoization means
    overlapping windows (stride < clip_len: every reference recipe) never
    re-decode their shared frames — the cold epoch decodes each frame exactly
    once — and RAM holds each frame once instead of clip_len/stride times.
    The reference re-decoded every frame of every window every epoch, its
    true input bottleneck (SURVEY.md §2 native-component note).
    """

    def __init__(self, clips: Sequence[ClipSpec], labels: np.ndarray,
                 cfg: DataConfig):
        assert len(clips) == len(labels)
        self.clips = list(clips)
        self.labels = np.asarray(labels, np.float32)
        self.cfg = cfg
        # per-video frame-level ground truth ({video: (T,) 0/1}) when the
        # ground_truth label policy loaded any; read by the frame-AUC report
        self.frame_labels = None
        # two tiers, both uint8, both GIL-atomic-dict safe under the
        # BatchLoader thread pool (a duplicate decode in two threads is
        # benign): _frames dedups the decode, _cache makes warm epochs a
        # single dict hit per clip
        self._cache: dict = {} if cfg.cache_decoded else None  # idx -> clip
        self._frames: dict = {} if cfg.cache_decoded else None  # path -> frame

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.float32]:
        cfg = self.cfg
        if self._cache is not None:
            # values pass through uint8 on every epoch (consistent across
            # epochs, and exactly the reference's precision — it resized
            # uint8 frames before normalizing)
            clip = self.get_uint8(idx)[0].astype(np.float32) / 255.0
        else:
            clip = self._decode_clip(self.clips[idx].frames)
        lo, hi = cfg.normalize_clamp
        if (lo, hi) != (0.0, 1.0):
            clip = np.clip(clip, lo, hi)  # family B clamp (:113-114)
        return clip, self.labels[idx]

    def _native_eligible(self, paths: Sequence[str]) -> bool:
        """True iff `_decode_clip` would take the (internally threaded)
        native C++ path for these frames."""
        if self.cfg.decode_backend not in ("auto", "native"):
            return False
        from cvad_tpu_torch.data.native_decoder import (load_library,
                                                  supported_suffixes)

        suffixes = supported_suffixes()
        return (load_library() is not None and bool(suffixes)
                and all(p.lower().endswith(suffixes) for p in paths))

    def warm_frames(self, indices: Sequence[int]) -> None:
        """Decode every not-yet-cached frame these clips reference in ONE
        (internally threaded) native call — the BatchLoader calls this before
        collating a batch so overlapping windows in the same batch neither
        race to decode their shared frames nor decode them twice."""
        frames = self._frames  # local ref: survives a concurrent release
        if frames is None:
            return
        need, seen = [], set()
        for i in indices:
            if i in self._cache:
                continue
            for p in self.clips[i].frames:
                if p not in frames and p not in seen:
                    seen.add(p)
                    need.append(p)
        if not need:
            return
        if not self._native_eligible(need):
            # PIL/cv2 fallback decodes one frame per call on THIS (single)
            # producer thread — warming here would serialize work the
            # loader's pool runs in parallel per clip; let get_uint8 decode
            # (the frame tier still dedups across overlapping windows)
            return
        dec8 = np.round(self._decode_clip(need) * 255.0).astype(np.uint8)
        for p, f in zip(need, dec8):
            frames[p] = f

    def get_uint8(self, idx: int) -> Tuple[np.ndarray, np.float32]:
        """Raw uint8 clip for the low-bandwidth transfer path (normalize
        happens on device)."""
        paths = self.clips[idx].frames
        if self._cache is None:
            clip = self._decode_clip(paths)
            return np.round(clip * 255.0).astype(np.uint8), self.labels[idx]
        clip8 = self._cache.get(idx)
        if clip8 is None:
            # local ref throughout: a concurrent release (below) swaps
            # self._frames but cannot pull entries out from under an
            # in-flight assembly (interrupted-epoch producers can overlap a
            # resumed epoch on the same dataset)
            frames = self._frames
            missing = [p for p in paths if p not in frames]
            if missing:  # only frames no other window brought in yet
                dec8 = np.round(self._decode_clip(missing) * 255.0
                                ).astype(np.uint8)
                for p, f in zip(missing, dec8):
                    frames[p] = f
            clip8 = np.stack([frames[p] for p in paths])
            self._cache[idx] = clip8
            if len(self._cache) == len(self.clips) and self._frames:
                # every clip is assembled: the frame tier is dead weight
                # (~1/overlap of the clip tier) — release it.  (Runs whose
                # access never covers ALL clips — host shards, drop_last
                # tails — keep the tier resident; acceptable, it is the
                # smaller of the two.)
                self._frames = {}
        return clip8, self.labels[idx]

    def _decode_clip(self, paths: Sequence[str]) -> np.ndarray:
        cfg = self.cfg
        # the native gate covers the real dataset formats: UCSD Ped2 .tif
        # (minicausal_vad_complete3.py:141-143) and Avenue jpg/png
        # (avenue_training_script_bbox.py:391); native decode is
        # bit-identical to PIL for all of them
        if self._native_eligible(paths):
            from cvad_tpu_torch.data.native_decoder import decode_clip

            out = decode_clip(paths, cfg.frame_size, cfg.channels,
                              cfg.num_decode_threads)
            if out is not None:
                return out
        frames = [decode.decode_frame(p, cfg.frame_size,
                                      grayscale=cfg.channels == 1,
                                      backend=cfg.decode_backend)
                  for p in paths]
        return np.stack(frames)


class SyntheticClipDataset:
    """In-memory synthetic clips (fixtures and benchmarks; no host IO)."""

    def __init__(self, cfg: DataConfig, n: int = 256, split: str = "Train",
                 anomaly_rate: Optional[float] = None):
        rate = anomaly_rate
        if rate is None:
            rate = 0.2 if split.lower() == "train" else 0.5
        self.data, self.labels = make_synthetic_clips(
            n, cfg.clip_len, cfg.frame_size, cfg.channels, rate,
            seed=cfg.seed + (0 if split.lower() == "train" else 1),
            profile=cfg.synthetic_profile)
        lo, hi = cfg.normalize_clamp
        if (lo, hi) != (0.0, 1.0):
            self.data = np.clip(self.data, lo, hi)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int):
        return self.data[idx], self.labels[idx]

    def get_uint8(self, idx: int):
        return (np.round(self.data[idx] * 255.0).astype(np.uint8),
                self.labels[idx])


def _gt_labels(root: str, split: str, videos) -> dict:
    """Frame-level ground truth for the ``ground_truth`` label policy."""
    from cvad_tpu_torch.data.ground_truth import load_gt_frame_labels

    return load_gt_frame_labels(root, split, [name for name, _ in videos])


def _folder_dataset(root: str, split: str, cfg: DataConfig, policy: str
                    ) -> ClipDataset:
    videos = scan_video_folders(str(Path(root) / split))
    clips = clip_windows(videos, cfg.clip_len, cfg.stride,
                         cfg.max_clips_per_video)
    lengths = [len(frames) for _, frames in videos]
    frame_labels = (_gt_labels(root, split, videos)
                    if policy == "ground_truth" else None)
    labels = assign_labels(policy, clips, split, lengths,
                           frame_labels=frame_labels)
    ds = ClipDataset(clips, labels, cfg)
    ds.frame_labels = frame_labels
    return ds


class UCSDPed2Dataset(ClipDataset):
    """UCSD Ped2 frame folders, reference variants via `cfg.label_policy`."""

    def __init__(self, root: str, split: str = "Train",
                 cfg: DataConfig = DataConfig()):
        ds = _folder_dataset(root, split, cfg, cfg.label_policy or "none")
        super().__init__(ds.clips, ds.labels, cfg)
        self.frame_labels = ds.frame_labels


class AvenueDataset(ClipDataset):
    """CUHK Avenue frames.  Layout-flexible: accepts
    ``<root>/{training,testing}/frames/<video>/``, ``<root>/{Train,Test}/``,
    or flat video folders; labels default to zeros (unsupervised training,
    like the reference pipeline)."""

    _SPLIT_DIRS = {
        "train": ("training/frames", "training", "Train", "train", "training_frames"),
        "test": ("testing/frames", "testing", "Test", "test", "testing_frames"),
    }

    def __init__(self, root: str, split: str = "Train",
                 cfg: DataConfig = DataConfig()):
        key = "train" if split.lower().startswith("train") else "test"
        rootp = Path(root)
        subdir = next((d for d in self._SPLIT_DIRS[key]
                       if (rootp / d).is_dir()), None)
        if subdir is None:
            raise FileNotFoundError(
                f"no {key} split under {root} (tried {self._SPLIT_DIRS[key]})")
        videos = scan_video_folders(str(rootp / subdir))
        clips = clip_windows(videos, cfg.clip_len, cfg.stride,
                             cfg.max_clips_per_video)
        lengths = [len(frames) for _, frames in videos]
        policy = cfg.label_policy or "none"
        frame_labels = (_gt_labels(root, split, videos)
                        if policy == "ground_truth" else None)
        labels = assign_labels(policy, clips, split, lengths,
                               frame_labels=frame_labels)
        super().__init__(clips, labels, cfg)
        self.frame_labels = frame_labels


def build_dataset(cfg: DataConfig, split: str = "Train", n_synthetic: int = 256):
    if cfg.dataset == "synthetic":
        return SyntheticClipDataset(cfg, n=n_synthetic, split=split)
    if cfg.dataset in ("ucsd_ped2", "ucsd_ped2_simple"):
        return UCSDPed2Dataset(cfg.root, split, cfg)
    if cfg.dataset == "avenue":
        return AvenueDataset(cfg.root, split, cfg)
    raise KeyError(f"unknown dataset {cfg.dataset!r}")


def create_avenue_dataloaders(dataset_path: str, batch_size: int = 4,
                              num_workers: int = 2, clip_length: int = 8,
                              frame_size: Tuple[int, int] = (64, 64)):
    """Reference-compatible entry point (missing-module contract, SURVEY.md
    §2.1): returns (train_loader, test_loader) yielding
    ``(videos, labels)`` with videos shaped (B, 3, clip_length, H, W) —
    torch layout, matching ``CompactFeatureExtractor`` input_channels=3."""
    from cvad_tpu_torch.data.batcher import BatchLoader

    cfg = DataConfig(dataset="avenue", root=dataset_path, clip_len=clip_length,
                     frame_size=frame_size, channels=3, stride=4,
                     batch_size=batch_size,
                     num_decode_threads=max(num_workers, 1))
    train = AvenueDataset(dataset_path, "Train", cfg)
    test = AvenueDataset(dataset_path, "Test", cfg)
    mk = lambda ds, shuffle: _TupleLoader(BatchLoader(
        ds, batch_size, shuffle=shuffle, torch_layout=True,
        num_threads=max(num_workers, 1)))
    return mk(train, True), mk(test, False)


class _TupleLoader:
    """Adapter to the reference's iteration contract: it unpacks
    ``for videos, labels in loader`` (``avenue_training_script2.py:217``),
    while :class:`BatchLoader` yields ``{"clips", "labels"}`` dicts."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            yield b["clips"], b["labels"]

    def __getattr__(self, name):  # passthrough (dataset, batch_size, ...)
        return getattr(self.loader, name)
