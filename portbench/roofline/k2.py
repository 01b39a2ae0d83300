"""K2, the masked pairwise L1 mean of family D's consistency loss
(``csrc/pairwise_l1.cu``), forward and backward, over `rows` masked rows
of a (B, N) float32 matrix.

Operations: three per (i, j, k) (a difference, its absolute value, a
sum), over the unordered pairs i < j in the forward and over the ordered
pairs in the backward, as ``scripts/probe_torch_pairwise.py`` counts
them.  Bytes: the matrix and the mask read once, the forward's two
scalars written, the backward's gradient matrix written.  Float32, so the
peak outside the tensor cores.
"""

from portbench.harness import PEAK_BYTES_S, PEAK_FLOPS

NAME = "pairwise_"  # pairwise_tiles, pairwise_finalize, pairwise_backward_*
COUNTERS = ("launches.pairwise_l1_forward", "launches.pairwise_l1_backward")


def forward_bound_s(b: int, n: int, rows: float) -> float:
    ops = 3 * rows * (rows - 1) / 2 * n
    return max(ops / PEAK_FLOPS["float32"], (b * n + b + 2) * 4 / PEAK_BYTES_S)


def backward_bound_s(b: int, n: int, rows: float) -> float:
    ops = 3 * rows * rows * n
    return max(ops / PEAK_FLOPS["float32"],
               (2 * b * n + b + 2) * 4 / PEAK_BYTES_S)
