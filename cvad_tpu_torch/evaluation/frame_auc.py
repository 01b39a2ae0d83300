"""Frame-level ROC-AUC against real ground truth: the north-star metric.

Port of `cvad_tpu/evaluation/frame_auc.py` (`frame_level_auc`, `_minmax`,
`dataset_frame_auc`, `make_trainer_score_fn`).  Each test video is scored
window by window (`VideoScorer.score_video`'s per-frame curves) against
the per-frame annotations `cvad_tpu_torch.data.ground_truth` reads (UCSD
``Test00N_gt`` masks, Avenue ``.mat`` volumes, ``.npy`` vectors).  The AUC
is `evaluation/metrics.py::roc_auc` (average ranks, as scikit-learn
computes it), so the port needs no scikit-learn.

Protocol (the standard VAD evaluation):
- score every test video -> per-frame anomaly curve (mean of windows
  covering each frame);
- micro AUC: concatenate all videos' curves and labels, one ROC-AUC;
- also reported: per-video AUCs (where both classes appear) and their macro
  mean, plus a per-video min-max-normalized micro AUC.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from cvad_tpu_torch.evaluation.metrics import roc_auc


def frame_level_auc(score_video: Callable[[Sequence[str]],
                                          Dict[str, np.ndarray]],
                    videos: Sequence, frame_labels: Dict[str, np.ndarray]
                    ) -> Dict:
    """The frame-AUC report.

    `score_video(frames) -> {"frame_scores": (n,)}` is a
    `VideoScorer.score_video` (or any compatible callable); `videos` is
    ``[(name, frame_paths)]`` in scan order; `frame_labels` maps a video's
    name to its (n_frames,) 0/1 array.  Videos without ground truth are
    skipped (and listed in the report).
    """
    curves, labels, per_video = [], [], {}
    skipped = []
    for name, frames in videos:
        gt = frame_labels.get(name)
        if gt is None:
            skipped.append(name)
            continue
        curve = np.asarray(score_video(frames)["frame_scores"], np.float64)
        n = min(len(curve), len(gt))
        curve, gt = curve[:n], np.asarray(gt[:n], np.float64)
        curves.append(curve)
        labels.append(gt)
        per_video[name] = (roc_auc(curve, gt)
                           if len(np.unique(gt)) == 2 else None)
    if not curves:
        return {"frame_auc": None, "n_videos": 0, "n_frames": 0,
                "skipped_videos": skipped,
                "error": "no ground truth found for any video"}
    y = np.concatenate(labels)
    s = np.concatenate(curves)
    norm = np.concatenate([_minmax(c) for c in curves])
    vid_aucs = [a for a in per_video.values() if a is not None]
    both = len(np.unique(y)) == 2
    return {
        "frame_auc": roc_auc(s, y) if both else None,
        "frame_auc_normalized": roc_auc(norm, y) if both else None,
        "macro_auc": float(np.mean(vid_aucs)) if vid_aucs else None,
        "per_video_auc": per_video,
        "n_videos": len(curves),
        "n_frames": int(y.size),
        "anomalous_frames": int(y.sum()),
        "skipped_videos": skipped,
    }


def _minmax(c: np.ndarray) -> np.ndarray:
    lo, hi = float(c.min()), float(c.max())
    return (c - lo) / (hi - lo) if hi > lo else np.zeros_like(c)


def dataset_frame_auc(score_fn: Callable, data_cfg, root: str,
                      split: str = "Test", batch_size: int = 64,
                      frame_labels: Optional[Dict[str, np.ndarray]] = None
                      ) -> Dict:
    """Frame-AUC over a dataset tree: scan `root`/`split`'s video folders,
    load whatever ground truth exists, score every video with `score_fn`
    (a (B, T, H, W, C) -> scores callable), aggregate."""
    from cvad_tpu_torch.data.frames import scan_video_folders
    from cvad_tpu_torch.data.ground_truth import load_gt_frame_labels
    from cvad_tpu_torch.evaluation.scoring import VideoScorer

    rootp = Path(root)
    split_dir = next((rootp / s for s in
                      (split, split.capitalize(), split.lower(),
                       "testing/frames", "testing")
                      if (rootp / s).is_dir()), None)
    if split_dir is None:
        raise FileNotFoundError(f"no {split} split under {root}")
    videos = scan_video_folders(str(split_dir))
    if frame_labels is None:
        frame_labels = load_gt_frame_labels(root, split,
                                            [n for n, _ in videos])
    scorer = VideoScorer(score_fn, data_cfg, batch_size=batch_size)
    return frame_level_auc(scorer.score_video, videos, frame_labels)


def make_trainer_score_fn(trainer) -> Callable:
    """Batch scorer from a (restored) `cvad_tpu_torch.train.engine.Trainer`:
    its task's eval step, which returns per-clip ``predictions`` for
    families D, B, C and A.  The batch is padded to the mesh's data axis
    and sharded as `Trainer.evaluate` feeds it (`Trainer.put_batch`); the
    step gathers the ranks' rows and the padding is trimmed."""
    import torch

    def score(batch: np.ndarray) -> np.ndarray:
        n = len(batch)
        out = trainer.task.eval_step(trainer.state, trainer.put_batch({
            "clips": np.asarray(batch),
            "labels": np.zeros(n, np.float32)}))
        return out["predictions"].reshape(-1)[:n].to(
            torch.float32).cpu().numpy()

    return score
