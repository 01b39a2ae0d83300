"""Evaluation metrics of the port.

An own copy of `cvad_tpu/evaluation/metrics.py::family_d_eval_metrics`
(:19-35), numpy only: the reference's family-D eval dict, key for key.
"""

from __future__ import annotations

from typing import Dict

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
