"""Adjacency statistics used by evaluation.

An own copy of `cvad_tpu/ops/adjacency.py::unique_graph_count` (:24-27),
numpy only: uniqueness is a hash-set operation on the host.
"""

from __future__ import annotations

import numpy as np


def unique_graph_count(graphs: np.ndarray) -> int:
    """Number of distinct (N, N) graphs in a (B, N, N) batch."""
    flat = np.asarray(graphs).reshape(len(graphs), -1)
    return len(np.unique(flat, axis=0))
