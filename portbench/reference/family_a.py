"""Plain PyTorch reference of family A (the 12-stage causal pipeline of
``causal_anomaly_detection.py``, the ``causal_pipeline`` preset): the model,
its four-term loss, the clip + AdamW step, the benchmark's seeded weights
and the FLOP count.

It imports nothing of the port.  Departures from the reference script, as
the port also makes them (they are the configuration as it is run):

- the detector keeps a fixed K box slots with a validity mask and a
  fallback box in slot 0 of frames without a valid box;
- the GRU is flax's cell: one bias per r and z gate (``bias_ih``'s thirds;
  ``bias_hh``'s r and z thirds exist and are unread), a zero initial state;
- the stem (conv1, bn1) is frozen: no gradient, no decay;
- BatchNorm keeps 0.9 of its running statistics a step.

Departures from the port, to keep the two computations independent: the
BatchNorms are ``F.batch_norm`` (cuDNN's), the pools torch's, the loss is
written from the script's formulas, the optimizer works leaf by leaf.  The
dropout masks and the VAE's normal draw come from a generator seeded as
the trainer seeds each step, drawn in the order the forward draws them:
the detector's two masks (B, T, 512) and (B, T, 256), the VAE's noise
(B, K, F), the causal scorer's mask (B, 64), the direct classifier's two
masks (B, 512) and (B, 256).

Numerics: float32 with TF32 off, unless `tf32` asks for the control.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.family_d import (Schedule, adamw, epoch_ends,
                                          numerics, result, step_seed)

DETECTOR_BIAS = (180, 120, 25, 50, 150, 100, 20, 45, 210, 140, 30, 55,
                 120, 80, 22, 48, 240, 160, 28, 52)
FALLBACK_BOX = (180.0, 120.0, 30.0, 60.0)


def _mlp(i: int, dims: Sequence[int], drop_after: Sequence[int] = (),
         final: Optional[nn.Module] = None) -> nn.Sequential:
    """Linear, ReLU between layers, a placeholder where a dropout sits (the
    script's ``nn.Dropout``, applied by `_run` from the step's masks)."""
    layers = []
    for j, d in enumerate(dims):
        layers.append(nn.Linear(i, d))
        i = d
        if j < len(dims) - 1:
            layers.append(nn.ReLU())
        if j in drop_after:
            layers.append(nn.Dropout())
    if final is not None:
        layers.append(final)
    return nn.Sequential(*layers)


def _run(seq: nn.Sequential, x, masks=(), rates=()):
    """`seq` on x, the k-th dropout keeping `masks[k]` scaled by
    1 / (1 - `rates[k]`); none in eval."""
    k = 0
    for layer in seq:
        if isinstance(layer, nn.Dropout):
            if masks:
                x = torch.where(masks[k], x / (1 - rates[k]), 0.0)
            k += 1
        else:
            x = layer(x)
    return x


class GRU(nn.Module):
    def __init__(self, i: int, h: int):
        super().__init__()
        self.h = h
        self.weight_ih_l0 = nn.Parameter(torch.empty(3 * h, i))
        self.weight_hh_l0 = nn.Parameter(torch.empty(3 * h, h))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(3 * h))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(3 * h))

    def forward(self, x):
        n, t, _ = x.shape
        xw = F.linear(x, self.weight_ih_l0, self.bias_ih_l0)
        h = x.new_zeros(n, self.h)
        b_hn = self.bias_hh_l0[2 * self.h:]
        for s in range(t):
            xr, xz, xn = xw[:, s].chunk(3, 1)
            hr, hz, hn = F.linear(h, self.weight_hh_l0).chunk(3, 1)
            r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
            h = (1 - z) * torch.tanh(xn + r * (hn + b_hn)) + z * h
        return h


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Pipeline(nn.Module):
    """Frames (B, T, 1, 240, 360) in [0, 1] -> the final and causal scores,
    the direct softmax and each clip's KL."""

    def __init__(self, m: Mapping, in_channels: int = 1):
        super().__init__()
        ch, pool = m["backbone_channels"], tuple(m["backbone_pool"])
        k, f, d = m["max_boxes"], m["num_factors"], m["reid_dim"]
        self.m, self.pool = m, pool
        feat = ch[-1] * pool[0] * pool[1]
        bb = nn.Module()
        bb.conv1 = nn.Conv2d(in_channels, ch[0], 7, stride=2, padding=3)
        bb.bn1 = _bn(ch[0])
        for i, (ci, c, s) in enumerate(zip(ch[:-1], ch[1:], (1, 2, 2, 2))):
            setattr(bb, f"layer{i + 1}", nn.Sequential(
                nn.Conv2d(ci, c, 3, stride=s, padding=1), _bn(c), nn.ReLU(),
                nn.Conv2d(c, c, 3, padding=1), _bn(c), nn.ReLU()))
        self.backbone = bb
        det = nn.Module()
        det.detector_net = _mlp(feat, (512, 256, 128, 64), (0, 1), nn.ReLU())
        det.detector_net.append(nn.Linear(64, k * 4))
        self.detector = det
        tr = nn.Module()
        tr.reid_net = nn.Sequential(nn.Linear(4, 32), nn.ReLU(),
                                    nn.Linear(32, d), nn.ReLU(),
                                    nn.Linear(d, d))
        self.tracker = tr
        te = nn.Module()
        te.gru = GRU(4 + d, m["gru_hidden"])
        te.encoder = nn.Linear(m["gru_hidden"], m["traj_latent"])
        self.traj_encoder = te
        ce = nn.Module()
        ce.encoder = nn.Sequential(nn.Linear(m["traj_latent"], 32), nn.ReLU(),
                                   nn.Linear(32, 32), nn.ReLU())
        ce.mu_head = nn.Linear(32, f)
        ce.logvar_head = nn.Linear(32, f)
        self.causal_extractor = ce
        sl = nn.Module()
        sl.structure_params = nn.Parameter(torch.empty(f, f))
        sl.node_encoder = nn.Linear(f, 32)
        sl.edge_predictor = nn.Sequential(nn.Linear(64, 32), nn.ReLU(),
                                          nn.Linear(32, 1), nn.Sigmoid())
        self.structure_learner = sl
        dp = nn.Module()
        dp.dynamics_net = nn.Sequential(nn.Linear(f, 32), nn.ReLU(),
                                        nn.Linear(32, 32), nn.ReLU(),
                                        nn.Linear(32, f))
        self.dynamics_predictor = dp
        sc = nn.Module()
        sc.causal_scorer = _mlp(3 * f, (64, 32, 1), (0,), nn.Sigmoid())
        sc.motion_scorer = _mlp(2 * f, (32, 16, 1), (), nn.Sigmoid())
        sc.temporal_scorer = _mlp(f, (32, 16, 1), (), nn.Sigmoid())
        self.anomaly_scorer = sc
        self.direct_classifier = _mlp(feat, (512, 256, 128, 64, 2), (0, 1),
                                      nn.Softmax(dim=-1))
        if m["freeze_stem"]:
            for p in (*bb.conv1.parameters(), *bb.bn1.parameters()):
                p.requires_grad_(False)

    def backbone_features(self, x):
        b, t = x.shape[:2]
        bb = self.backbone
        x = x.reshape((b * t,) + x.shape[2:])
        x = F.relu(bb.bn1(bb.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            x = getattr(bb, f"layer{i}")(x)
        return F.adaptive_avg_pool2d(x, self.pool).reshape(b, t, -1)

    def forward(self, frames, draws: Optional[Sequence[torch.Tensor]] = None):
        """`draws`: the step's six draws in order, or None in eval."""
        m = self.m
        k, n = m["max_boxes"], m["num_factors"]
        feats = self.backbone_features(frames)
        dr = list(draws) if draws is not None else None
        take = (lambda c: [dr.pop(0) for _ in range(c)]) if dr else \
            (lambda c: [])
        raw = _run(self.detector.detector_net, feats, take(2), (0.3, 0.2))
        raw = raw.reshape(feats.shape[:-1] + (k, 4))
        s = torch.sigmoid(raw)
        x, y = s[..., 0] * 360.0, s[..., 1] * 240.0
        w, h = s[..., 2] * 80.0 + 15.0, s[..., 3] * 120.0 + 25.0
        valid = ((x >= 10) & (x <= 350) & (y >= 10) & (y <= 230)
                 & (w >= 10) & (w <= 100) & (h >= 20) & (h <= 150))
        none = ~valid.any(-1)
        fb = torch.tensor(FALLBACK_BOX, device=frames.device)
        boxes = torch.stack([x, y, w, h], -1)
        slot0 = torch.where(none[..., None], fb, boxes[..., 0, :])
        boxes = torch.cat([slot0[..., None, :], boxes[..., 1:, :]], -2)
        valid = torch.cat([(valid[..., 0] | none)[..., None],
                           valid[..., 1:]], -1)
        traj = torch.cat([boxes, self.tracker.reid_net(boxes)], -1)
        traj = traj * valid[..., None]
        traj_valid = valid.any(1)  # (B, K)
        b, t = traj.shape[:2]
        seq = traj.permute(0, 2, 1, 3).reshape(b * k, t, -1)
        enc = self.traj_encoder.encoder(self.traj_encoder.gru(seq))
        enc = enc.reshape(b, k, -1)
        ce = self.causal_extractor
        hid = ce.encoder(enc)
        mu, logvar = ce.mu_head(hid), ce.logvar_head(hid)
        z = mu + take(1)[0] * torch.exp(0.5 * logvar) if dr else mu
        kl = -0.5 * (1 + logvar - mu ** 2 - logvar.exp()).sum(-1)
        mask = traj_valid.float()
        kl = (kl * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
        factors = z * mask[..., None]
        factors = F.pad(factors, (0, 0, 0, n - k))
        node_valid = F.pad(traj_valid, (0, n - k), value=False)
        sl = self.structure_learner
        nodes = sl.node_encoder(factors)
        pairs = torch.cat([nodes[:, :, None].expand(b, n, n, 32),
                           nodes[:, None, :].expand(b, n, n, 32)], -1)
        e = sl.edge_predictor(pairs)[..., 0]
        pair_ok = (node_valid[:, :, None] & node_valid[:, None, :]).float()
        adj = e * pair_ok * (1 - torch.eye(n, device=e.device))
        predicted = self.dynamics_predictor.dynamics_net(
            torch.einsum("bij,bkj->bki", adj, factors))
        nm = node_valid[..., None].float()
        cnt = nm.sum(1).clamp(min=1.0)
        cur, pred = (factors * nm).sum(1) / cnt, (predicted * nm).sum(1) / cnt
        sc = self.anomaly_scorer
        causal = _run(sc.causal_scorer, torch.cat([cur, pred, (cur - pred)
                                                   .abs()], -1),
                      take(1), (0.2,))
        motion = sc.motion_scorer(torch.cat([cur, pred], -1))
        temporal = sc.temporal_scorer(cur)
        wc, wm, wt = m["scorer_blend"]
        causal = (wc * causal + wm * motion + wt * temporal)[..., 0]
        direct = _run(self.direct_classifier, feats.mean(1), take(2),
                      (0.3, 0.2))
        w0, w1 = m["score_blend"]
        return {"final": w0 * causal + w1 * direct[:, 1], "causal": causal,
                "direct": direct, "kl": kl}


def loss_fn(out, labels, c: Mapping):
    lab = labels.float()
    picked = out["direct"].clamp(1e-7, 1.0).gather(
        1, labels.long()[:, None])[:, 0]
    return (c["a_ce"] * -picked.log().mean()
            + c["a_score_mse"] * ((out["final"] - lab) ** 2).mean()
            + c["a_causal_mse"] * ((out["causal"] - lab) ** 2).mean()
            + c["a_kl"] * out["kl"].mean())


def draw_shapes(m: Mapping, b: int, t: int):
    """(shape, normal) of each of a training forward's draws, in order."""
    k, f = m["max_boxes"], m["num_factors"]
    return [((b, t, 512), False), ((b, t, 256), False), ((b, k, f), True),
            ((b, 64), False), ((b, 512), False), ((b, 256), False)]


def step_draws(m: Mapping, b: int, t: int, seed: int, step: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    out = []
    for (shape, normal), p in zip(draw_shapes(m, b, t),
                                  (0.3, 0.2, None, 0.2, 0.3, 0.2)):
        fn = torch.randn if normal else torch.rand
        d = fn(shape, generator=gen, device=device)
        out.append(d if normal else d >= p)
    return out


def train_steps(cfg: Mapping, weights: Mapping[str, torch.Tensor],
                batches: Sequence[torch.Tensor], labels: Sequence[torch.Tensor],
                seed: int, device, calls: Sequence[int], tf32: bool = False,
                drop_rows=None, compute: str = "float32") -> Dict:
    """As `family_d.train_steps`, over family A's steps in float32 (only
    `compute` 'float32'); the frozen stem and the parameters the loss does
    not read take no gradient."""
    if compute != "float32":
        raise ValueError(f"family A's reference computes in float32, not "
                         f"{compute}")
    m = cfg["model"]
    model = Pipeline(m, cfg["data"]["channels"]).to(device)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses, first, steps = [], None, []
    sched = Schedule(cfg["optim"], cfg["train"]["num_epochs"])
    ends = epoch_ends(calls, len(batches))
    for t, (clips, lab) in enumerate(zip(batches, labels)):
        clips, lab = clips.to(device), lab.to(device)
        b, frames_t = clips.shape[:2]
        draws = step_draws(m, b, frames_t, seed, t, device)
        x = clips.float().div(255.0).permute(0, 1, 4, 2, 3)
        if drop_rows is not None:
            rows = drop_rows(b)
            x, lab = x[rows], lab[rows]
            draws = [d[rows] for d in draws]
        with numerics(tf32):
            out = model.train()(x, draws)
            loss = loss_fn(out, lab, cfg["loss"])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        g = adamw(params, grads, mu, nu, t + 1, cfg["optim"], sched.lr)
        losses.append(float(loss.detach()))
        steps.append([p.detach().clone() for p in params])
        if first is None:
            first = [x.detach().clone() for x in g]
        if t in ends:
            sched.step(sum(losses[ends[t]:]) / (t + 1 - ends[t]))
    return result([n for n, _ in named], losses, first, mu, steps, sched.lr)


@torch.no_grad()
def scores(cfg: Mapping, weights: Mapping[str, torch.Tensor],
           clips: torch.Tensor, device, tf32: bool = False,
           block: int = 16) -> torch.Tensor:
    """The eval forward's final scores of uint8 clips (N, T, H, W, C), in
    blocks of `block` clips."""
    model = Pipeline(cfg["model"], cfg["data"]["channels"]).to(device)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    model.eval()
    out = []
    for s in range(0, len(clips), block):
        x = clips[s:s + block].to(device).float().div(255.0)
        with numerics(tf32):
            out.append(model(x.permute(0, 1, 4, 2, 3))["final"].float())
    return torch.cat(out)


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the state dict from one normal draw on `device`:
    conv, Linear and GRU kernels N(0, 1 / fan_in), `structure_params`
    N(0, 1), biases zero but the detector head's pattern, BatchNorm scale
    one and its running statistics fresh (mean 0, variance 1)."""
    shapes = Pipeline(cfg["model"], cfg["data"]["channels"]).to(
        "meta").state_dict()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    drawn = [n for n, v in shapes.items()
             if v.dim() >= 2 or n.endswith("structure_params")]
    flat = torch.randn(sum(shapes[n].numel() for n in drawn),
                       generator=gen, device=device)
    out, at = {}, 0
    for name, v in shapes.items():
        if name in drawn:
            k = v.numel()
            scale = 1.0 if name.endswith("structure_params") else \
                v[0].numel() ** -0.5
            out[name] = (flat[at:at + k] * scale).view(v.shape).contiguous()
            at += k
        elif name.endswith(("running_var",)) or (
                name.endswith("weight") and v.dim() == 1):
            out[name] = torch.ones(v.shape, device=device)
        else:
            out[name] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    head = out["detector.detector_net.10.bias"]
    pattern = torch.tensor(DETECTOR_BIAS, dtype=torch.float32, device=device)
    head.copy_(pattern.repeat(head.numel() // len(pattern) + 1)
               [:head.numel()])
    return out


def flops_per_clip(cfg: Mapping, train: bool, clips: int = 2) -> float:
    """Operations of one clip as `FlopCounterMode` counts the reference's
    on meta tensors: the forward, and where `train` its backward (the stem
    frozen, the frames taking no gradient)."""
    from torch.utils.flop_counter import FlopCounterMode

    m = cfg["model"]
    t, (h, w) = cfg["data"]["clip_len"], cfg["data"]["frame_size"]
    c = cfg["data"]["channels"]
    model = Pipeline(m, c).to("meta")
    model.train(train)
    x = torch.empty(clips, t, c, h, w, device="meta")
    with FlopCounterMode(display=False) as fc:
        draws = None
        if train:
            draws = [torch.empty(s, device="meta") if normal else
                     torch.empty(s, dtype=torch.bool, device="meta")
                     for s, normal in draw_shapes(m, clips, t)]
        out = model(x, draws)
        if train:
            (out["final"].sum() + out["kl"].sum()
             + out["direct"].sum()).backward()
    return fc.get_total_flops() / clips
