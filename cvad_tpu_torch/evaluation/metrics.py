"""Evaluation metrics of the port.

An own copy of `cvad_tpu/evaluation/metrics.py` (:19-134), numpy only:

- `family_d_eval_metrics`, the reference's family-D eval dict, key for key;
- family B's: `percentile_threshold` (the 95th percentile of the normal
  clips' scores), `binary_metrics` (AUC, accuracy, precision, recall and F1
  at a threshold) and `score_separation`.  `cvad_tpu` computes the binary
  metrics with scikit-learn; here they are written out in numpy with
  scikit-learn's definitions (zero_division=0, AUC from average ranks), so
  the port needs no scikit-learn;
- `format_sample_table`, the per-sample prediction table, and
  `family_a_test_analysis`, the reference's family-A test report;
- each family's eval dict (`cvad_tpu/train/engine.py:445-478`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from cvad_tpu_torch.ops.adjacency import unique_graph_count


def family_d_eval_metrics(predictions: np.ndarray, causal_graphs: np.ndarray,
                          edge_threshold: float = 0.1) -> Dict[str, float]:
    """Score statistics, edges and sparsity at `edge_threshold`, and the
    number of distinct graphs."""
    p = np.asarray(predictions).reshape(-1)
    g = np.asarray(causal_graphs)
    n_cells = g.shape[1] * g.shape[2] if g.ndim == 3 else 256
    edges = (g > edge_threshold).sum(axis=(1, 2))
    return {
        "mean_score": float(p.mean()),
        "std_score": float(p.std()),
        "min_score": float(p.min()),
        "max_score": float(p.max()),
        "score_range": float(p.max() - p.min()),
        "avg_edges": float(edges.mean()),
        "avg_sparsity": float((edges / n_cells).mean()),
        "unique_graphs": float(unique_graph_count(g)),
    }


def percentile_threshold(scores: np.ndarray, labels: np.ndarray,
                         percentile: float = 95.0) -> float:
    """The `percentile`-th percentile of the normal (label 0) scores, or of
    all scores when there is no normal one."""
    normal = np.asarray(scores)[np.asarray(labels) == 0]
    if normal.size == 0:
        return float(np.percentile(scores, percentile))
    return float(np.percentile(normal, percentile))


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the ROC curve of binary `labels` (1 positive): the
    Mann-Whitney statistic over average ranks, which is what
    ``sklearn.metrics.roc_auc_score`` gives, ties included."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    pos = np.asarray(labels).reshape(-1) == 1
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_s = scores[order]
    # average rank (1-based) over each run of equal scores
    starts = np.flatnonzero(np.r_[True, sorted_s[1:] != sorted_s[:-1]])
    ends = np.r_[starts[1:], len(scores)]
    for s, e in zip(starts, ends):
        ranks[order[s:e]] = (s + 1 + e) / 2.0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def binary_metrics(scores: np.ndarray, labels: np.ndarray,
                   threshold: Optional[float] = None) -> Dict[str, float]:
    """AUC, accuracy, precision, recall and F1 of ``scores > threshold``
    (default 0.5, the reference's fixed cut); precision, recall and F1 are
    0 where their denominator is, and AUC is NaN for a single-class eval."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1).astype(int)
    thr = 0.5 if threshold is None else threshold
    preds = (scores > thr).astype(int)
    tp = int(((preds == 1) & (labels == 1)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())

    def ratio(num: int, den: int) -> float:
        return float(num / den) if den else 0.0

    out = {
        "accuracy": float((preds == labels).mean()),
        "precision": ratio(tp, tp + fp),
        "recall": ratio(tp, tp + fn),
        "f1": ratio(2 * tp, 2 * tp + fp + fn),
        "threshold": float(thr),
    }
    out["auc"] = (roc_auc(scores, labels) if len(np.unique(labels)) > 1
                  else float("nan"))
    return out


def format_sample_table(scores: np.ndarray, labels: np.ndarray,
                        threshold: float = 0.5, max_rows: int = 50) -> str:
    """Per-sample prediction table (the reference's ``test_model`` print,
    ``causal_anomaly_detection.py:796-835``), returned as a string."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    lines = [f"{'idx':>5} {'score':>8} {'pred':>5} {'label':>5} {'ok':>3}"]
    for i in range(min(len(scores), max_rows)):
        pred = int(scores[i] > threshold)
        ok = "y" if pred == int(labels[i]) else "n"
        lines.append(f"{i:>5} {scores[i]:>8.4f} {pred:>5} {int(labels[i]):>5} "
                     f"{ok:>3}")
    if len(scores) > max_rows:
        lines.append(f"... ({len(scores) - max_rows} more)")
    return "\n".join(lines)


def family_a_test_analysis(scores: np.ndarray, labels: np.ndarray,
                           direct_predictions: np.ndarray,
                           threshold: float = 0.5,
                           max_rows: int = 10) -> Dict[str, object]:
    """The reference family-A ``test_model`` report
    (``causal_anomaly_detection.py:796-835``): prediction counts by both
    methods (blended score > `threshold`, argmax of the direct softmax) and
    the first `max_rows` per-sample rows, as a dict."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1).astype(int)
    direct = np.asarray(direct_predictions).reshape(len(scores), -1)
    anomaly_pred = (scores > threshold).astype(int)
    class_pred = np.argmax(direct, axis=1)
    return {
        "total_samples": int(len(labels)),
        "true_normal": int((labels == 0).sum()),
        "true_abnormal": int((labels == 1).sum()),
        "score_pred_normal": int((anomaly_pred == 0).sum()),
        "score_pred_abnormal": int((anomaly_pred == 1).sum()),
        "class_pred_normal": int((class_pred == 0).sum()),
        "class_pred_abnormal": int((class_pred == 1).sum()),
        "samples": [
            {"index": i + 1, "true": int(labels[i]),
             "score": float(scores[i]),
             "anomaly_pred": int(anomaly_pred[i]),
             "class_pred": int(class_pred[i])}
            for i in range(min(max_rows, len(labels)))
        ],
    }


def score_separation(scores: np.ndarray, labels: np.ndarray
                     ) -> Dict[str, float]:
    """Mean score of the normal and of the abnormal clips, and their
    difference (NaN for a class with no clip)."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    normal = scores[labels == 0]
    abnormal = scores[labels == 1]
    out = {
        "normal_mean": float(normal.mean()) if normal.size else float("nan"),
        "abnormal_mean": (float(abnormal.mean()) if abnormal.size
                          else float("nan")),
    }
    out["separation"] = out["abnormal_mean"] - out["normal_mean"]
    return out


def family_b_eval_metrics(predictions: np.ndarray, labels: np.ndarray,
                          loss: np.ndarray) -> Dict[str, float]:
    """Family B's eval dict (`cvad_tpu/train/engine.py:457-463`): the
    binary metrics at the 95th percentile of the normal scores, the score
    separation, and ``val_loss``, the mean per-sample reconstruction
    error."""
    thr = percentile_threshold(predictions, labels)
    m = binary_metrics(predictions, labels, thr)
    m.update(score_separation(predictions, labels))
    m["val_loss"] = float(np.mean(loss))
    return m


def family_c_eval_metrics(predictions: np.ndarray, labels: np.ndarray,
                          loss: np.ndarray) -> Dict[str, float]:
    """Family C's eval dict (`cvad_tpu/train/engine.py:452-456`): the
    binary metrics at 0.5 and ``loss``, the mean per-clip BCE."""
    m = binary_metrics(predictions, labels)
    m["loss"] = float(np.mean(loss))
    return m


def family_a_eval_metrics(predictions: np.ndarray, labels: np.ndarray,
                          direct_predictions: np.ndarray) -> Dict[str, Any]:
    """Family A's eval dict (`cvad_tpu/train/engine.py:464-478`): the
    binary metrics of the blended score at 0.5, ``val_acc`` (their
    accuracy) and ``analysis`` (`family_a_test_analysis`)."""
    m: Dict[str, Any] = binary_metrics(predictions, labels)
    m["val_acc"] = m["accuracy"]
    m["analysis"] = family_a_test_analysis(predictions, labels,
                                           direct_predictions)
    return m
