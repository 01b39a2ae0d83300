"""The losses of families D, A and B, in PyTorch.

Port of `cvad_tpu/ops/losses.py:21-150`: binary cross-entropy (family C's
loss), the focal loss as the reference composes it, the masked mean,
pseudo-labels and the five-term ``improved_loss``, whose consistency term
calls the port's `pairwise_l1_mean`, which launches K2 for CUDA tensors;
family A's four-term `family_a_loss`.  Also
`family_b_reconstruction_loss`, the reference's MSE -> L1 -> 0 chain (the
family-B train step computes the same MSE from sufficient statistics and
does not call it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cvad_tpu_torch.config import LossConfig
from cvad_tpu_torch.ops.pallas_kernels import pairwise_l1_mean

_EPS = 1e-7


def binary_cross_entropy(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities, p clipped to [1e-7, 1 - 1e-7]."""
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Mean over the rows (axis 0) that `valid` keeps; plain mean without
    a mask."""
    if valid is None:
        return x.mean()
    w = valid.reshape(valid.shape[0], *([1] * (x.dim() - 1)))
    return (x * w).sum() / torch.clamp(
        valid.sum() * (x.numel() / x.shape[0]), min=1.0)


def focal_bce(p: torch.Tensor, t: torch.Tensor, alpha: float = 0.25,
              gamma: float = 2.0, valid: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """ce -> pt = exp(-ce) -> alpha (1 - pt)^gamma ce, mean over `valid`."""
    ce = binary_cross_entropy(p, t)
    pt = torch.exp(-ce)
    focal = alpha * (1.0 - pt) ** gamma * ce
    return _masked_mean(focal, valid)


def pseudo_labels(generator: torch.Generator, batch: int, rate: float,
                  device=None) -> torch.Tensor:
    """Random pseudo-labels: a `rate` fraction anomalous (uniform >
    1 - rate), drawn from `generator`."""
    u = torch.rand(batch, generator=generator, device=device)
    return (u > (1.0 - rate)).float()


def improved_loss(anomaly_scores: torch.Tensor, causal_adj: torch.Tensor,
                  pseudo_targets: torch.Tensor, cfg: LossConfig = LossConfig(),
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Family-D five-term loss: focal anomaly, acyclicity
    tr((mean adj)^2), sparsity |edge share - target|, consistency
    |avg pairwise normal-adjacency L1 - target|, and the band penalty on the
    batch edge count.  `valid` (B,) excludes padded rows from every term.
    Scores (B, 1) or (B,), adjacency (B, N, N), targets (B,)."""
    b = causal_adj.shape[0]
    v = (torch.ones(b, dtype=torch.float32, device=causal_adj.device)
         if valid is None else valid.float())
    n_valid = torch.clamp(v.sum(), min=1.0)
    scores = anomaly_scores.reshape(-1)
    anomaly = focal_bce(scores, pseudo_targets, cfg.focal_alpha,
                        cfg.focal_gamma, valid=valid)

    mean_adj = (causal_adj * v[:, None, None]).sum(0) / n_valid
    # the diagonal's sum, not torch.trace, whose backward reads its
    # gradient on the host (no CUDA graph can hold that)
    acyclicity = torch.diagonal(mean_adj @ mean_adj).sum()

    edges = (causal_adj > cfg.edge_threshold).float()
    per_cell = causal_adj.shape[1] * causal_adj.shape[2]
    edge_count = (edges * v[:, None, None]).sum()
    current_sparsity = edge_count / (n_valid * per_cell)
    sparsity = torch.abs(current_sparsity - cfg.target_sparsity)

    normal = (pseudo_targets == 0).float() * v
    flat = causal_adj.reshape(b, -1).contiguous()
    avg_dist, n_pairs = pairwise_l1_mean(flat, normal)
    zero = torch.zeros_like(avg_dist)
    consistency = torch.where(
        n_pairs > 0, torch.abs(avg_dist - cfg.consistency_target), zero)

    structure = torch.where(
        edge_count < cfg.min_edges, (cfg.min_edges - edge_count) * 0.01,
        torch.where(edge_count > cfg.max_edges,
                    (edge_count - cfg.max_edges) * 0.01, zero))

    total = (cfg.anomaly_weight * anomaly
             + cfg.causal_weight * acyclicity
             + cfg.sparsity_weight * sparsity
             + cfg.consistency_weight * consistency
             + cfg.structure_weight * structure)
    components = {
        "anomaly_loss": anomaly,
        "acyclicity_loss": acyclicity,
        "sparsity_loss": sparsity,
        "consistency_loss": consistency,
        "structure_loss": structure,
        "edge_count": edge_count,
        "sparsity_ratio": current_sparsity,
    }
    return total, components


def family_a_loss(outputs: Dict[str, torch.Tensor], labels: torch.Tensor,
                  cfg: LossConfig = LossConfig(),
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Family A's loss (``causal_anomaly_detection.py:649-662``):
    ``a_ce`` CE of the direct softmax (clipped to [1e-7, 1]) at the label
    + ``a_score_mse`` MSE(final score, label) + ``a_causal_mse``
    MSE(causal score, label) + ``a_kl`` KL, each a mean over the rows
    `valid` keeps."""
    labels_f = labels.float()
    direct = torch.clamp(outputs["direct_predictions"], _EPS, 1.0)
    picked = direct.gather(1, labels.long().reshape(-1, 1))[:, 0]
    ce = _masked_mean(-torch.log(picked), valid)
    score_mse = _masked_mean((outputs["anomaly_scores"] - labels_f) ** 2,
                             valid)
    causal_mse = _masked_mean(
        (outputs["causal_anomaly_scores"] - labels_f) ** 2, valid)
    kl = _masked_mean(outputs["kl_losses"], valid)
    total = (cfg.a_ce * ce + cfg.a_score_mse * score_mse
             + cfg.a_causal_mse * causal_mse + cfg.a_kl * kl)
    return total, {"ce": ce, "score_mse": score_mse,
                   "causal_mse": causal_mse, "kl": kl}


def family_b_reconstruction_loss(pred: torch.Tensor, target: torch.Tensor
                                 ) -> torch.Tensor:
    """MSE of `pred` clamped to (1e-8, 1 - 1e-8) against `target`; the L1
    where the MSE is not finite, and 0 where neither is
    (``causal_anomaly_detection1.py:323-344``), as device-side selects."""
    pred = torch.clamp(pred, 1e-8, 1.0 - 1e-8)
    mse = torch.mean((pred - target) ** 2)
    l1 = torch.mean(torch.abs(pred - target))
    out = torch.where(torch.isfinite(mse), mse, l1)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
