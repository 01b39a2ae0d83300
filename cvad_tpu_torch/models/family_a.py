"""Family A: the 12-stage causal pipeline, in PyTorch.

Port of `cvad_tpu/models/family_a.py`, `cvad_tpu`'s fixed-shape rebuild of
``causal_anomaly_detection.py:110-586`` (and, with ``anchor_variant``, of
``video_anomaly_detection.py:67-454``): a per-frame 2D conv backbone; a
detector with K box slots, a validity mask and a fallback box in slot 0
where a frame has no valid box; ReID on every box; a GRU over each slot's
boxes through time; a VAE factor head; an edge MLP over all factor pairs; a
dynamics MLP; the anomaly scorers; and a direct classifier on the
time-pooled backbone features.  Trajectory k is slot k traced through time,
valid where any frame's k-th box is.

Layout: frames (B, T, C, H, W), as family B takes them; the backbone runs
the B*T frames folded into the batch, and its (B*T, C, 4, 6) pooled map is
flattened channel-major, as the reference's ``view`` does.  (`cvad_tpu`
flattens it (h, w, c) and permutes the rows of the two layers that read it
when it imports a reference ``.pth``; the carry in
`runtime/checkpoint.py` applies the inverse.)  The module tree gives the
reference's state-dict keys (``backbone.conv1``, ``backbone.layer{1-4}``,
``detector.detector_net``, ``tracker.reid_net``, ``traj_encoder.gru``,
``causal_extractor``, ``structure_learner``, ``dynamics_predictor``,
``anomaly_scorer``, ``direct_classifier``), so a reference ``.pth`` loads
with ``load_state_dict(strict=True)``.

The GRU is written out with flax's cell arithmetic (zero initial state;
r, z from the input projection plus the hidden one; n = tanh(input + r *
(hidden + b_hn))), not ``nn.GRU``: cuDNN's RNN is another summation order
and is not deterministic by default.  It keeps ``nn.GRU``'s parameter
names.  Its r and z gates hold ONE bias each, as flax's cell does:
``bias_ih_l0``'s r and z thirds; ``bias_hh_l0``'s r and z thirds are zero
and unread (a reference state dict loads with them added into
``bias_ih_l0``), so that a train step moves one bias per gate, as
`cvad_tpu`'s optimizer does.

Randomness: in ``train()`` mode the VAE samples z = mu + e * std, with e
from `vae_noise` (the one place the draw is made, so that a test can put
another framework's draw there), and dropout draws its masks; both take
the `torch.Generator` passed to `forward`.  In ``eval()`` mode z = mu and
there is no dropout.  With ``cfg.dtype='bfloat16'`` the layers compute in
bf16 by explicit casts; parameters and BatchNorm statistics stay float32,
the KL is computed in float32 and the scores leave in float32.  Otherwise
everything runs in the parameters' type (float64 for a copy cast with
``.double()``, a reference on the CPU).
``cfg.freeze_stem`` sets ``requires_grad=False`` on the backbone's conv1
and bn1 (bn1's running statistics still update); ``cfg.remat`` runs the
backbone under ``torch.utils.checkpoint``, its BatchNorms' running
statistics updated once, by the first forward.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cvad_tpu_torch.config import FamilyAConfig
from cvad_tpu_torch.models.init import lecun_normal_
from cvad_tpu_torch.parallel.collectives import random
from cvad_tpu_torch.models.layers import (MaskedBatchNorm, accumulate,
                                          adaptive_avg_pool2d, compute_dtype,
                                          linear, mlp, run_seq)

# the detector head's bias: plausible pedestrian boxes
# (causal_anomaly_detection.py:183-192)
DETECTOR_BIAS = (180, 120, 25, 50, 150, 100, 20, 45, 210, 140, 30, 55,
                 120, 80, 22, 48, 240, 160, 28, 52)
FALLBACK_BOX = (180.0, 120.0, 30.0, 60.0)
ANCHORS = 3  # the anchor detector's box slots


def vae_noise(shape: Tuple[int, ...], dtype: torch.dtype,
              device: torch.device,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The VAE's standard-normal draw e of z = mu + e * std, drawn in
    float32 and cast to `dtype` (so runs in other dtypes take the same
    draw)."""
    return random(shape, generator, device, normal=True).to(dtype)


def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                    layer.stride, layer.padding)


class ResNetBackbone(nn.Module):
    """Per-frame 2D conv backbone (``causal_anomaly_detection.py:110-158``):
    7x7/2 conv, BatchNorm, ReLU, 3x3/2 max pool, four stages of two 3x3
    convs with BatchNorm and ReLU (strides 1, 2, 2, 2), adaptive average
    pool to `backbone_pool`.  (B, T, C, H, W) -> (B, T, C_last * 4 * 6)."""

    def __init__(self, cfg: FamilyAConfig, in_channels: int = 1):
        super().__init__()
        ch = cfg.backbone_channels
        self.cfg = cfg
        self.conv1 = nn.Conv2d(in_channels, ch[0], 7, stride=2, padding=3)
        self.bn1 = MaskedBatchNorm(ch[0])
        for i, (c_in, c, s) in enumerate(zip(ch[:-1], ch[1:], (1, 2, 2, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                nn.Conv2d(c_in, c, 3, stride=s, padding=1),
                MaskedBatchNorm(c), nn.ReLU(),
                nn.Conv2d(c, c, 3, padding=1), MaskedBatchNorm(c),
                nn.ReLU()))

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                update_stats: bool = True) -> torch.Tensor:
        b, t = x.shape[:2]
        x = x.reshape((b * t,) + x.shape[2:]).to(
            compute_dtype(self.cfg.dtype, self.conv1.weight))
        # the clip's padding mask, repeated for each of its frames
        fvalid = None if valid is None else valid.repeat_interleave(t)
        x = F.relu(self.bn1(_conv(self.conv1, x), fvalid, update_stats))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            for layer in getattr(self, f"layer{i}"):
                if isinstance(layer, nn.Conv2d):
                    x = _conv(layer, x)
                elif isinstance(layer, MaskedBatchNorm):
                    x = layer(x, fvalid, update_stats)
                else:
                    x = layer(x)
        x = adaptive_avg_pool2d(x, tuple(self.cfg.backbone_pool))
        return x.reshape(b, t, -1)  # channel-major, the reference's view


class MaskedPedestrianDetector(nn.Module):
    """The fixed-K detector (``SimplePedestrianDetector``, :160-230): MLP
    feat -> 512 -> 256 -> 128 -> 64 -> K*4 (dropout 0.3 and 0.2 after the
    first two), sigmoid ranges x [0, 360], y [0, 240], w [15, 95], h [25,
    145]; valid where 10 <= x <= 350, 10 <= y <= 230, 10 <= w <= 100 and
    20 <= h <= 150; the fallback box [180, 120, 30, 60] in slot 0 of frames
    where no box is valid."""

    def __init__(self, cfg: FamilyAConfig, features: int):
        super().__init__()
        self.k = cfg.max_boxes
        net = mlp(features, (512, 256, 128, 64), final_activation="relu",
                  dropout_after=(0, 1), dropout_rates=(0.3, 0.2))
        net.append(nn.Linear(64, self.k * 4))
        self.detector_net = net

    def reset_bias(self) -> None:
        """The head's bias pattern, tiled or cut to K*4 (np.resize)."""
        head = self.detector_net[-1]
        n = head.bias.numel()
        pattern = torch.tensor(DETECTOR_BIAS, dtype=torch.float32)
        with torch.no_grad():
            head.bias.copy_(pattern.repeat(n // len(pattern) + 1)[:n])

    def forward(self, feats: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        raw = run_seq(self.detector_net, feats, training, generator)
        raw = raw.reshape(feats.shape[:-1] + (self.k, 4))
        x = torch.sigmoid(raw[..., 0]) * 360.0
        y = torch.sigmoid(raw[..., 1]) * 240.0
        w = torch.sigmoid(raw[..., 2]) * 80.0 + 15.0
        h = torch.sigmoid(raw[..., 3]) * 120.0 + 25.0
        boxes = torch.stack([x, y, w, h], dim=-1)  # (B, T, K, 4)
        valid = ((x >= 10) & (x <= 350) & (y >= 10) & (y <= 230)
                 & (w >= 10) & (w <= 100) & (h >= 20) & (h <= 150))
        return fallback_slot0(boxes, valid, FALLBACK_BOX)


def fallback_slot0(boxes: torch.Tensor, valid: torch.Tensor, box
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frames where no slot is valid get `box` in slot 0, made valid.  The
    box's coordinates enter as scalars: a tensor made from them would be a
    host-to-device copy, which a captured CUDA graph refuses."""
    none = ~valid.any(dim=-1)  # (B, T)
    slot0 = torch.stack([torch.where(none, v, boxes[..., 0, j])
                         for j, v in enumerate(box)], dim=-1)
    boxes = torch.cat([slot0[..., None, :], boxes[..., 1:, :]], dim=-2)
    valid = torch.cat([(valid[..., 0] | none)[..., None], valid[..., 1:]],
                      dim=-1)
    return boxes, valid


class AnchorPedestrianDetector(nn.Module):
    """The earlier anchor detector (``video_anomaly_detection.py:117-165``):
    a bbox head feat -> 3*4 raw coordinates and a confidence head feat -> 3
    sigmoids; valid where the confidence exceeds 0.5, a zero box in slot 0
    of frames where none does."""

    def __init__(self, cfg: FamilyAConfig, features: int):
        super().__init__()
        self.k = ANCHORS
        self.bbox_head = nn.Linear(features, self.k * 4)
        self.conf_head = nn.Linear(features, self.k)

    def forward(self, feats: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        boxes = linear(self.bbox_head, feats).reshape(
            feats.shape[:-1] + (self.k, 4))
        conf = torch.sigmoid(linear(self.conf_head, feats))
        return fallback_slot0(boxes, conf > 0.5, (0.0, 0.0, 0.0, 0.0))


class TrajectoryTracker(nn.Module):
    """ReID on every box (:232-274): MLP 4 -> 32 -> D -> D, then [box, reid]
    (B, T, K, 4 + D), zero where the box is not valid."""

    def __init__(self, cfg: FamilyAConfig):
        super().__init__()
        d = cfg.reid_dim
        self.reid_net = nn.Sequential(nn.Linear(4, 32), nn.ReLU(),
                                      nn.Linear(32, d), nn.ReLU(),
                                      nn.Linear(d, d))

    def forward(self, boxes: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
        traj = torch.cat([boxes, run_seq(self.reid_net, boxes)], dim=-1)
        return traj * valid[..., None].to(traj.dtype)


class GRU(nn.Module):
    """One-layer GRU with flax's cell arithmetic and ``nn.GRU``'s parameter
    names (see the module docstring)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih_l0 = nn.Parameter(torch.empty(3 * hidden, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(3 * hidden))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's defaults, gate by gate (r, z, n): lecun-normal input
        kernels, orthogonal recurrent kernels, zero biases."""
        h, i = self.hidden, self.weight_ih_l0.shape[1]
        for g in range(3):
            rows = slice(g * h, (g + 1) * h)
            block = torch.empty(h, i)
            self.weight_ih_l0[rows] = lecun_normal_(block, gen)
            rec = torch.empty(h, h)
            nn.init.orthogonal_(rec, generator=gen)
            self.weight_hh_l0[rows] = rec.T
        self.bias_ih_l0.zero_()
        self.bias_hh_l0.zero_()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a reference state dict: its r and z hidden biases join the input
        # ones (torch only ever adds the two)
        ih, hh = prefix + "bias_ih_l0", prefix + "bias_hh_l0"
        if ih in state_dict and hh in state_dict:
            h = state_dict[hh].shape[0] // 3
            b_ih, b_hh = state_dict[ih].clone(), state_dict[hh].clone()
            b_ih[:2 * h] += b_hh[:2 * h]
            b_hh[:2 * h] = 0
            state_dict = {**state_dict, ih: b_ih, hh: b_hh}
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, I) in the compute dtype -> the last hidden state (N, H),
        at least float32 (flax carries the state in the parameters'
        type)."""
        n, t, _ = x.shape
        hd = self.hidden
        dt = x.dtype
        xw = F.linear(x.reshape(n * t, -1), self.weight_ih_l0.to(dt),
                      self.bias_ih_l0.to(dt)).reshape(n, t, 3 * hd)
        w_hh = self.weight_hh_l0.to(dt).T
        b_hn = self.bias_hh_l0[2 * hd:].to(dt)
        h = accumulate(x.new_zeros((n, hd)))
        for s in range(t):
            gh = h.to(dt) @ w_hh
            xr, xz, xn = xw[:, s].chunk(3, dim=1)
            hr, hz, hn = gh.chunk(3, dim=1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            c = torch.tanh(xn + r * (hn + b_hn))
            h = (1.0 - z) * c + z * h
        return h


class TrajectoryEncoder(nn.Module):
    """The GRU over time of every slot (:276-309), on the folded (B*K, T,
    4 + D) tensor, then a Linear to `traj_latent`: (B, K, L)."""

    def __init__(self, cfg: FamilyAConfig):
        super().__init__()
        self.gru = GRU(4 + cfg.reid_dim, cfg.gru_hidden)
        self.encoder = nn.Linear(cfg.gru_hidden, cfg.traj_latent)

    def forward(self, traj: torch.Tensor) -> torch.Tensor:
        b, t, k, d = traj.shape
        seq = traj.permute(0, 2, 1, 3).reshape(b * k, t, d)
        h = self.gru(seq).to(traj.dtype)
        return linear(self.encoder, h).reshape(b, k, -1)


class CausalFactorExtractor(nn.Module):
    """The VAE head (:311-352) over (B, K, L): mu and logvar of
    `num_factors`, z = mu + e * exp(logvar / 2) in training (mu in eval),
    zero for invalid slots, and each clip's KL (float32) averaged over its
    valid slots."""

    def __init__(self, cfg: FamilyAConfig):
        super().__init__()
        f = cfg.num_factors
        self.encoder = nn.Sequential(nn.Linear(cfg.traj_latent, 32),
                                     nn.ReLU(), nn.Linear(32, 32), nn.ReLU())
        self.mu_head = nn.Linear(32, f)
        self.logvar_head = nn.Linear(32, f)

    def forward(self, enc: torch.Tensor, traj_valid: torch.Tensor,
                sample: bool, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = run_seq(self.encoder, enc)
        mu = linear(self.mu_head, h)
        logvar = linear(self.logvar_head, h)
        if sample:
            std = torch.exp(0.5 * logvar)
            z = mu + vae_noise(tuple(std.shape), std.dtype, std.device,
                               generator) * std
        else:
            z = mu
        muf, lvf = accumulate(mu), accumulate(logvar)
        kl = -0.5 * torch.sum(1 + lvf - muf ** 2 - torch.exp(lvf), dim=-1)
        m = traj_valid.to(kl.dtype)
        kl_mean = (kl * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
        return z * m[..., None].to(z.dtype), kl_mean


def pad_nodes(factors: torch.Tensor, valid: torch.Tensor, n: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots padded with zeros (or cut) to `n` graph nodes."""
    k = factors.shape[1]
    if k < n:
        return (F.pad(factors, (0, 0, 0, n - k)),
                F.pad(valid, (0, n - k), value=False))
    return factors[:, :n], valid[:, :n]


class CausalStructureLearner(nn.Module):
    """The edge model (:354-398) as one batched MLP over all (B, N, N)
    pairs of node embeddings: sigmoid edge weights, zero on the diagonal
    and between invalid nodes; `structure_params` (N, N) broadcast."""

    def __init__(self, cfg: FamilyAConfig):
        super().__init__()
        n = cfg.num_factors
        self.n = n
        self.structure_params = nn.Parameter(torch.empty(n, n))
        self.node_encoder = nn.Linear(n, 32)
        self.edge_predictor = nn.Sequential(nn.Linear(64, 32), nn.ReLU(),
                                            nn.Linear(32, 1), nn.Sigmoid())

    def forward(self, factors: torch.Tensor, traj_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.n
        b = factors.shape[0]
        factors_n, node_valid = pad_nodes(factors, traj_valid, n)
        nodes = linear(self.node_encoder, factors_n)  # (B, N, 32)
        pairs = torch.cat([nodes[:, :, None].expand(b, n, n, 32),
                           nodes[:, None, :].expand(b, n, n, 32)], dim=-1)
        e = run_seq(self.edge_predictor, pairs)[..., 0]  # (B, N, N)
        mask = (node_valid[:, :, None] & node_valid[:, None, :]).to(e.dtype)
        eye = torch.eye(n, dtype=e.dtype, device=e.device)
        adj = e * mask * (1.0 - eye)
        return adj, self.structure_params.expand(b, n, n)


class DynamicsPredictor(nn.Module):
    """Message passing and an MLP (:400-426): structured[b, k] =
    adj[b] @ factors[b, k], then F -> 32 -> 32 -> F."""

    def __init__(self, cfg: FamilyAConfig):
        super().__init__()
        f = cfg.num_factors
        self.dynamics_net = nn.Sequential(nn.Linear(f, 32), nn.ReLU(),
                                          nn.Linear(32, 32), nn.ReLU(),
                                          nn.Linear(32, f))

    def forward(self, factors: torch.Tensor, adj: torch.Tensor
                ) -> torch.Tensor:
        structured = torch.einsum("bij,bkj->bki", adj.to(factors.dtype),
                                  factors)
        return run_seq(self.dynamics_net, structured)


def _masked_node_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


class EnhancedAnomalyScorer(nn.Module):
    """The three-head scorer (:428-502) on the valid nodes' mean factors
    and predictions: causal (3F -> 64 -> 32 -> 1, dropout 0.2 after the
    first), motion (2F -> 32 -> 16 -> 1) and temporal (F -> 32 -> 16 -> 1),
    sigmoids blended by `scorer_blend`."""

    def __init__(self, cfg: FamilyAConfig):
        super().__init__()
        f = cfg.num_factors
        self.blend = tuple(cfg.scorer_blend)
        self.causal_scorer = mlp(3 * f, (64, 32, 1), "sigmoid", dropout=0.2,
                                 dropout_after=(0,))
        self.motion_scorer = mlp(2 * f, (32, 16, 1), "sigmoid")
        self.temporal_scorer = mlp(f, (32, 16, 1), "sigmoid")

    def forward(self, factors: torch.Tensor, predicted: torch.Tensor,
                node_valid: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        m = node_valid[:, :factors.shape[1], None].to(factors.dtype)
        cur = _masked_node_mean(factors, m)
        pred = _masked_node_mean(predicted, m)
        diff = torch.abs(cur - pred)
        causal = run_seq(self.causal_scorer, torch.cat([cur, pred, diff], -1),
                         training, generator)
        motion = run_seq(self.motion_scorer, torch.cat([cur, pred], -1))
        temporal = run_seq(self.temporal_scorer, cur)
        w = self.blend
        return (w[0] * causal + w[1] * motion + w[2] * temporal)[..., 0]


class SimpleAnomalyScorer(nn.Module):
    """The earlier one-head scorer (``video_anomaly_detection.py:375-403``):
    3F -> 32 -> 16 -> 1 sigmoid on [factors, predicted, |difference|] of
    every node, averaged over the valid nodes."""

    def __init__(self, cfg: FamilyAConfig):
        super().__init__()
        self.score_net = mlp(3 * cfg.num_factors, (32, 16, 1), "sigmoid")

    def forward(self, factors: torch.Tensor, predicted: torch.Tensor,
                node_valid: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = torch.cat([factors, predicted, torch.abs(factors - predicted)],
                      -1)
        s = run_seq(self.score_net, x)[..., 0]  # (B, N)
        m = node_valid[:, :factors.shape[1]].to(s.dtype)
        return (s * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


class CausalPipelineDetector(nn.Module):
    """Frames (B, T, C, H, W) in [0, 1] -> `cvad_tpu`'s ten outputs:
    ``anomaly_scores`` (B,), ``causal_factors`` (B, K, F),
    ``trajectory_mask`` (B, K), ``adjacency_matrices`` and
    ``structure_params`` (B, N, N), ``kl_losses`` (B,), ``detections``
    (B, T, K, 4), ``detection_mask`` (B, T, K), ``direct_predictions`` (B,
    2) and ``causal_anomaly_scores`` (B,)."""

    def __init__(self, cfg: Optional[FamilyAConfig] = None,
                 in_channels: int = 1, seed: int = 0):
        super().__init__()
        cfg = cfg or FamilyAConfig()
        self.cfg = cfg
        feat = cfg.backbone_channels[-1] * cfg.backbone_pool[0] \
            * cfg.backbone_pool[1]
        with torch.random.fork_rng(devices=[]):  # no global draw
            self.backbone = ResNetBackbone(cfg, in_channels)
            self.detector = (AnchorPedestrianDetector(cfg, feat)
                             if cfg.anchor_variant
                             else MaskedPedestrianDetector(cfg, feat))
            self.tracker = TrajectoryTracker(cfg)
            self.traj_encoder = TrajectoryEncoder(cfg)
            self.causal_extractor = CausalFactorExtractor(cfg)
            self.structure_learner = CausalStructureLearner(cfg)
            self.dynamics_predictor = DynamicsPredictor(cfg)
            self.anomaly_scorer = (SimpleAnomalyScorer(cfg)
                                   if cfg.anchor_variant
                                   else EnhancedAnomalyScorer(cfg))
            if cfg.direct_variant:
                self.direct_classifier = mlp(
                    feat, (512, 256, 128, 64, 2), "softmax",
                    dropout_after=(0, 1), dropout_rates=(0.3, 0.2))
        # parameters no loss reads, as in `cvad_tpu`: structure_params is
        # an output only, and the anchor detector's confidence only decides
        # validity; the train step gives them exactly zero gradient
        # (`train/tasks.py::stop_bn_absorbed_biases`)
        self.zero_grad_params = ("structure_learner.structure_params",) + (
            ("detector.conf_head.weight", "detector.conf_head.bias")
            if cfg.anchor_variant else ())
        self.reset_parameters(seed)
        if cfg.freeze_stem:
            for p in (*self.backbone.conv1.parameters(),
                      *self.backbone.bn1.parameters()):
                p.requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """`cvad_tpu`'s initialisation (flax's defaults) from a generator
        seeded with `seed`, in module order: lecun-normal conv and Linear
        kernels, zero biases, the GRU's own, `structure_params` from
        normal(0, 1), and the detector head's bias pattern."""
        gen = torch.Generator().manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                lecun_normal_(mod.weight, gen)
                mod.bias.zero_()
            elif isinstance(mod, GRU):
                mod.reset_parameters(gen)
        self.structure_learner.structure_params.normal_(0.0, 1.0,
                                                        generator=gen)
        if isinstance(self.detector, MaskedPedestrianDetector):
            self.detector.reset_bias()

    def _features(self, frames: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> torch.Tensor:
        if not (self.cfg.remat and self.training and torch.is_grad_enabled()):
            return self.backbone(frames, valid)
        calls = []

        def run(x):
            # the recomputation in the backward normalises with the same
            # batch statistics and leaves the running ones as they are
            calls.append(None)
            return self.backbone(x, valid, update_stats=len(calls) == 1)

        return checkpoint(run, frames, use_reentrant=False)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                valid: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """`valid` (B,) keeps padded clips out of the BatchNorm statistics
        in ``train()`` mode; `generator` feeds the VAE draw and dropout
        there."""
        cfg = self.cfg
        training = self.training
        feats = self._features(frames, valid)
        boxes, box_valid = self.detector(feats, training, generator)
        traj = self.tracker(boxes, box_valid)
        traj_valid = box_valid.any(dim=1)  # (B, K): the slot ever valid
        enc = self.traj_encoder(traj)
        factors, kl = self.causal_extractor(enc, traj_valid, training,
                                            generator)
        adj, structure = self.structure_learner(factors, traj_valid)
        factors_n, node_valid = pad_nodes(factors, traj_valid,
                                          cfg.num_factors)
        predicted = self.dynamics_predictor(factors_n, adj)
        causal = accumulate(self.anomaly_scorer(factors_n, predicted,
                                                node_valid, training,
                                                generator))
        if cfg.direct_variant:
            direct = accumulate(run_seq(self.direct_classifier,
                                        feats.mean(dim=1), training,
                                        generator))
            w0, w1 = cfg.score_blend
            final = w0 * causal + w1 * direct[:, 1]
        else:
            final = causal
            direct = torch.stack([1.0 - causal, causal], dim=-1)
        return {"anomaly_scores": final, "causal_factors": factors,
                "trajectory_mask": traj_valid, "adjacency_matrices": adj,
                "structure_params": structure, "kl_losses": kl,
                "detections": boxes, "detection_mask": box_valid,
                "direct_predictions": direct,
                "causal_anomaly_scores": causal}
