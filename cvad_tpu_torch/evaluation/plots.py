"""Plot dashboards.

Port of `cvad_tpu/evaluation/plots.py` (the reference's matplotlib suites):
``visualize_results`` (ROC, score histograms and boxplots, factor
correlations, a stats panel; ``causal_anomaly_detection.py:938-1016``),
``create_additional_analysis`` (factor evolution, mean adjacency, moving
average, KL, t-SNE, precision-recall, detection counts, factor-score
correlation; ``:1018-1167``, ``video_anomaly_detection.py:778-992``),
``visualize_training_results`` (the 2x2 history dashboard,
``avenue_training_script1.py:228-291``; it reads the keys that
`runtime/history.py` writes) and ``visualize_bounding_boxes`` (family A's
detections over frames, ``causal_anomaly_detection.py:841-936``).

Each function writes a PNG and returns its path, or None where
matplotlib (or scikit-learn, where it needs it) is absent.  Nothing here
touches the device.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np


def _plt():
    """matplotlib's pyplot on the Agg backend, or None without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _sklearn_metrics():
    try:
        from sklearn import metrics
    except ImportError:
        return None
    return metrics


def visualize_results(scores: np.ndarray, labels: np.ndarray,
                      factors: Optional[np.ndarray], out_path: str,
                      dpi: int = 150) -> Optional[str]:
    """ROC + histogram + boxplot + factor-correlation + stats panel."""
    plt, metrics = _plt(), _sklearn_metrics()
    if plt is None or metrics is None:
        return None

    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    fig, axes = plt.subplots(2, 3, figsize=(18, 10))

    ax = axes[0, 0]
    if len(np.unique(labels)) > 1:
        fpr, tpr, _ = metrics.roc_curve(labels, scores)
        ax.plot(fpr, tpr, label=f"AUC = {metrics.auc(fpr, tpr):.3f}")
        ax.plot([0, 1], [0, 1], "k--", alpha=0.5)
        ax.legend()
    ax.set_title("ROC Curve")
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")

    ax = axes[0, 1]
    ax.hist(scores[labels == 0], bins=30, alpha=0.6, label="normal")
    ax.hist(scores[labels == 1], bins=30, alpha=0.6, label="anomaly")
    ax.legend()
    ax.set_title("Score Distributions")

    ax = axes[0, 2]
    data = [scores[labels == 0], scores[labels == 1]]
    ax.boxplot([d if d.size else [0] for d in data],
               tick_labels=["normal", "anomaly"])
    ax.set_title("Score Boxplot")

    ax = axes[1, 0]
    if factors is not None and len(factors):
        f = np.asarray(factors).reshape(len(factors), -1)
        if f.shape[0] > 1:
            corr = np.corrcoef(f.T)
            im = ax.imshow(np.nan_to_num(corr), cmap="coolwarm", vmin=-1, vmax=1)
            fig.colorbar(im, ax=ax)
    ax.set_title("Causal Factor Correlation")

    ax = axes[1, 1]
    ax.plot(scores, lw=0.8)
    anomalies = np.where(labels == 1)[0]
    if anomalies.size:
        ax.scatter(anomalies, scores[anomalies], c="r", s=8, label="anomaly")
        ax.legend()
    ax.set_title("Scores Over Samples")

    ax = axes[1, 2]
    ax.axis("off")
    stats = (f"n = {len(scores)}\n"
             f"mean = {scores.mean():.4f}\nstd = {scores.std():.4f}\n"
             f"min = {scores.min():.4f}\nmax = {scores.max():.4f}\n"
             f"anomaly rate = {labels.mean():.3f}")
    ax.text(0.1, 0.5, stats, fontsize=13, family="monospace", va="center")
    ax.set_title("Statistics")

    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return str(out_path)


def create_additional_analysis(outputs: Mapping[str, np.ndarray],
                               out_path: str, dpi: int = 150
                               ) -> Optional[str]:
    """Multi-panel analysis dashboard over eval outputs.

    Expects any of: 'predictions', 'labels', 'causal_graphs' (B, N, N),
    'factors' (B, K, F) or (B, F), 'kl_losses' (B,), 'detection_counts' (B,).
    Panels are drawn for whatever is present (the reference draws a fixed
    8-12 grid); the precision-recall and t-SNE panels need scikit-learn.
    """
    plt, metrics = _plt(), _sklearn_metrics()
    if plt is None:
        return None
    preds = np.asarray(outputs.get("predictions", np.zeros(1))).reshape(-1)
    labels = outputs.get("labels")
    fig, axes = plt.subplots(3, 3, figsize=(18, 14))
    axs = axes.ravel()
    k = 0

    def next_ax():
        nonlocal k
        a = axs[k]
        k += 1
        return a

    if "factors" in outputs:
        f = np.asarray(outputs["factors"])
        f2 = f.reshape(f.shape[0], -1)
        ax = next_ax()
        for i in range(min(6, f2.shape[1])):
            ax.plot(f2[:, i], lw=0.7, label=f"f{i}")
        ax.set_title("Causal Factor Evolution")
        ax.legend(fontsize=7)

    if "causal_graphs" in outputs:
        g = np.asarray(outputs["causal_graphs"])
        ax = next_ax()
        im = ax.imshow(g.mean(axis=0), cmap="Reds", vmin=0, vmax=1)
        fig.colorbar(im, ax=ax)
        ax.set_title("Mean Adjacency")
        ax = next_ax()
        ax.hist((g > 0.1).sum(axis=(1, 2)), bins=20)
        ax.set_title("Edges per Graph (>0.1)")

    ax = next_ax()
    win = max(len(preds) // 20, 1)
    if len(preds) >= win:
        ma = np.convolve(preds, np.ones(win) / win, mode="valid")
        ax.plot(ma)
    ax.set_title(f"Score Moving Average (w={win})")

    if "kl_losses" in outputs:
        ax = next_ax()
        ax.plot(np.asarray(outputs["kl_losses"]).reshape(-1), lw=0.7)
        ax.set_title("KL per Sample")

    if (metrics is not None and labels is not None
            and len(np.unique(labels)) > 1):
        pr, rc, _ = metrics.precision_recall_curve(labels, preds)
        ax = next_ax()
        ax.plot(rc, pr, label="AP = "
                f"{metrics.average_precision_score(labels, preds):.3f}")
        ax.set_title("Precision-Recall")
        ax.legend()

    if "factors" in outputs and len(preds) > 10:
        f2 = np.asarray(outputs["factors"]).reshape(len(preds), -1)
        try:
            from sklearn.manifold import TSNE

            n = min(len(preds), 300)
            emb = TSNE(n_components=2, perplexity=min(30, max(2, n // 4)),
                       init="random", random_state=0).fit_transform(f2[:n])
            ax = next_ax()
            c = labels[:n] if labels is not None else preds[:n]
            ax.scatter(emb[:, 0], emb[:, 1], c=c, cmap="coolwarm", s=8)
            ax.set_title("t-SNE of Factors")
        except (ImportError, ValueError):  # no sklearn; too few samples
            pass
        ax = next_ax()
        corr = [np.corrcoef(f2[:, i], preds)[0, 1] if f2[:, i].std() > 0 else 0
                for i in range(min(f2.shape[1], 16))]
        ax.bar(range(len(corr)), corr)
        ax.set_title("Factor-Score Correlation")

    if "detection_counts" in outputs:
        ax = next_ax()
        ax.hist(np.asarray(outputs["detection_counts"]).reshape(-1),
                bins=range(0, 8))
        ax.set_title("Detections per Clip")

    for a in axs[k:]:
        a.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return str(out_path)


def visualize_training_results(history: Mapping, out_path: str,
                               dpi: int = 150) -> Optional[str]:
    """2x2 history dashboard (``avenue_training_script1.py:228-291``):
    losses, loss components, eval mean scores, sparsity."""
    plt = _plt()
    if plt is None:
        return None
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))

    axes[0, 0].plot(history.get("epochs", []), history.get("train_losses", []))
    axes[0, 0].set_title("Training Loss")
    axes[0, 0].set_xlabel("epoch")

    comps = history.get("loss_components", [])
    if comps:
        keys = [key for key in comps[0]
                if key.endswith("_loss") and key != "loss"]
        for key in keys:
            axes[0, 1].plot([c.get(key, np.nan) for c in comps], label=key,
                            lw=0.9)
        axes[0, 1].legend(fontsize=7)
        axes[0, 1].set_yscale("symlog", linthresh=1e-5)
    axes[0, 1].set_title("Loss Components")

    evals = history.get("evaluation_metrics", [])
    if evals:
        for key in ("mean_score", "score_range", "auc"):
            vals = [e.get(key) for e in evals]
            if any(v is not None for v in vals):
                axes[1, 0].plot([v if v is not None else np.nan for v in vals],
                                marker="o", label=key)
        axes[1, 0].legend()
        sp = [e.get("avg_sparsity") for e in evals]
        if any(v is not None for v in sp):
            axes[1, 1].plot([v if v is not None else np.nan for v in sp],
                            marker="s")
    axes[1, 0].set_title("Evaluation Metrics")
    axes[1, 1].set_title("Graph Sparsity")

    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return str(out_path)


def visualize_bounding_boxes(frames: np.ndarray, boxes: np.ndarray,
                             mask: np.ndarray, out_path: str,
                             scores: Optional[np.ndarray] = None,
                             max_frames: int = 8, dpi: int = 150
                             ) -> Optional[str]:
    """Family-A detection overlay (``causal_anomaly_detection.py:841-936``):
    center-format (x, y, w, h) boxes -> corner rectangles over frames."""
    plt = _plt()
    if plt is None:
        return None
    from matplotlib.patches import Rectangle

    frames = np.asarray(frames)
    t = min(frames.shape[0], max_frames)
    cols = min(t, 4)
    rows = (t + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4.2 * cols, 3.2 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[divmod(i, cols)]
        ax.axis("off")
        if i >= t:
            continue
        img = frames[i, ..., 0] if frames.shape[-1] == 1 else frames[i]
        ax.imshow(img, cmap="gray" if frames.shape[-1] == 1 else None)
        title = f"frame {i}"
        if scores is not None:
            title += f"  score={float(np.asarray(scores).reshape(-1)[0]):.2f}"
        ax.set_title(title, fontsize=9)
        for k in range(boxes.shape[1]):
            if not mask[i, k]:
                continue
            x, y, w, h = boxes[i, k]
            ax.add_patch(Rectangle((x - w / 2, y - h / 2), w, h,
                                   linewidth=1.5, edgecolor="r",
                                   facecolor="none"))
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return str(out_path)
