"""Label policies: the reference's synthetic ones, plus real ground truth.

An own copy of `cvad_tpu/data/labels.py`, numpy and the standard library
only.  The draws are kept as they are (`heuristic_v1` seeds Python's
`random` per clip, `mixed_simple`'s class-balance flip draws from
``np.random.default_rng(0)``), so the labels equal `cvad_tpu`'s.

All three reference UCSD datasets fabricate labels (SURVEY.md §4: the
pipelines are runnable without ground truth).  Those policies are observable
behavior, so they are preserved verbatim here.

Policies (name -> reference source):
- ``heuristic_v1``  — ``causal_anomaly_detection.py:65-80``: seeded-RNG
  probability from folder parity + frame progress.
- ``hardcoded_v2``  — ``causal_anomaly_detection1.py:84-92``: anomaly video
  set {1,2,4,5,6,9,10,11,12}, middle 20-80% of frames anomalous.
- ``split_binary``  — ``video_anomaly_detection.py:40``: Train=0 / Test=1.
- ``mixed_simple``  — ``minicausal_vad_complete3.py:165-185``: 20% of train /
  50% of test clips anomalous by index arithmetic, with forced class balance.
- ``none``          — all zeros (e.g. Avenue training, which is unsupervised).
- ``ground_truth``  — REAL per-frame annotations via
  :mod:`cvad_tpu_torch.data.ground_truth` (UCSD ``Test00N_gt`` mask folders
  the reference skips at ``minicausal_vad_complete3.py:141-143``, Avenue
  ``N_label.mat`` volumes, ``.npy`` vectors); a clip is anomalous iff any
  frame in its window is.  This is what the north-star frame-AUC
  (BASELINE.md) evaluates against.
"""

from __future__ import annotations

import random
import re
from typing import List, Sequence

import numpy as np

from cvad_tpu_torch.data.frames import ClipSpec


def _folder_num(name: str) -> int:
    m = re.search(r"(\d+)", name)
    return int(m.group(1)) if m else 0


def heuristic_v1(clips: Sequence[ClipSpec], split: str, video_lengths) -> List[int]:
    labels = []
    for c in clips:
        if split.lower() == "train":
            labels.append(0)
            continue
        folder_num = _folder_num(c.video)
        n = video_lengths[c.video_index]
        clip_len = len(c.frames)
        progress = c.start / max(n - clip_len, 1)
        prob = 0.0
        if folder_num in (1, 3, 5, 7, 9, 11):
            prob += 0.4
        if progress > 0.6:
            prob += 0.3
        if 0.3 < progress < 0.7:
            prob += 0.2
        random.seed(folder_num * 1000 + c.start)
        labels.append(1 if random.random() < prob else 0)
    return labels


def hardcoded_v2(clips: Sequence[ClipSpec], split: str, video_lengths) -> List[int]:
    anomaly_videos = {1, 2, 4, 5, 6, 9, 10, 11, 12}
    labels = []
    for c in clips:
        if split.lower() == "train":
            labels.append(0)
            continue
        folder_num = _folder_num(c.video)
        n = video_lengths[c.video_index]
        progress = c.start / max(n - len(c.frames), 1)
        labels.append(1 if folder_num in anomaly_videos and 0.2 <= progress <= 0.8
                      else 0)
    return labels


def split_binary(clips: Sequence[ClipSpec], split: str, video_lengths) -> List[int]:
    v = 0 if split.lower() == "train" else 1
    return [v] * len(clips)


def mixed_simple(clips: Sequence[ClipSpec], split: str, video_lengths) -> List[int]:
    labels = []
    per_video_count: dict = {}
    for c in clips:
        k = per_video_count.get(c.video_index, 0)
        if split.lower() == "train":
            labels.append(1 if (c.video_index * k) % 5 == 0 else 0)
        else:
            labels.append(1 if k % 2 == 0 else 0)
        per_video_count[c.video_index] = k + 1
    # forced class balance (:176-185)
    if len(set(labels)) < 2 and labels:
        normal_idx = [i for i, l in enumerate(labels) if l == 0]
        if normal_idx:
            flip = min(len(normal_idx) // 3, 10)
            for i in np.random.default_rng(0).choice(normal_idx, flip,
                                                     replace=False):
                labels[int(i)] = 1
        else:
            labels[0] = 0
    return labels


def none_policy(clips: Sequence[ClipSpec], split: str, video_lengths) -> List[int]:
    return [0] * len(clips)


def ground_truth_policy(clips: Sequence[ClipSpec], split: str, video_lengths,
                        frame_labels=None) -> List[int]:
    """Real annotations (see module docstring).  `frame_labels` is the
    per-video frame-label dict the dataset layer loads from disk; videos
    without ground truth (every Train split) label as normal."""
    from cvad_tpu_torch.data.ground_truth import clip_labels_from_frames

    return list(clip_labels_from_frames(clips, frame_labels or {}))


POLICIES = {
    "heuristic_v1": heuristic_v1,
    "hardcoded_v2": hardcoded_v2,
    "split_binary": split_binary,
    "mixed_simple": mixed_simple,
    "none": none_policy,
    "ground_truth": ground_truth_policy,
}


def assign_labels(policy: str, clips: Sequence[ClipSpec], split: str,
                  video_lengths: Sequence[int],
                  frame_labels=None) -> np.ndarray:
    fn = POLICIES.get(policy)
    if fn is None:
        raise KeyError(f"unknown label policy {policy!r}")
    if policy == "ground_truth":
        return np.asarray(fn(clips, split, list(video_lengths),
                             frame_labels=frame_labels), np.float32)
    return np.asarray(fn(clips, split, list(video_lengths)), np.float32)
