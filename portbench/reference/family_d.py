"""Plain PyTorch reference of family D (the causal anomaly detector of
``avenue_training_script2.py``): the model, the five-term loss, the
clip + AdamW step, the benchmark's seeded weights and the FLOP count.

It imports nothing of the port.  Departures from the port, each kept on
purpose so that the two computations are independent:

- conv1 is ``F.conv3d`` (the port runs its K1 kernel on the card);
- the pool is ``F.adaptive_avg_pool3d`` (the port's own at 16x16 frames);
- the consistency term is a masked ``torch.cdist(p=1)`` over all pairs
  (the port runs its K2 kernel, forward and backward);
- the gradient is autograd's over every parameter, the optimizer works
  leaf by leaf (the port's over one flat vector);
- the dropout masks and pseudo-labels are drawn from a generator seeded as
  the trainer seeds each step (`step_seed`), in the order the trainer
  draws them: pseudo-labels (B,), the fc's mask (B, 16), the graph
  encoder's mask (B, hidden).  That order is the only thing the reference
  shares with the program, and a change to it is a change of result.

Numerics: float32 with TF32 off (cuDNN and matmul), unless `tf32` asks
for the control, the same steps with TF32 on.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Detector(nn.Module):
    """Clips (B, 3, T, 64, 64) -> (scores (B, 1), adjacency (B, d, d))."""

    def __init__(self, m: Mapping):
        super().__init__()
        c1, c2, c3 = m["conv_channels"]
        d = m["causal_dim"]
        self.d = d
        self.p = m["dropout"]
        self.pool_out = tuple(m["pool_out"])
        fe = nn.Module()
        fe.conv3d_1 = nn.Conv3d(m["in_channels"], c1, 3, stride=(1, 2, 2),
                                padding=1)
        fe.conv3d_2 = nn.Conv3d(c1, c2, 3, stride=2, padding=1)
        fe.conv3d_3 = nn.Conv3d(c2, c3, 3, stride=2, padding=1)
        fe.fc = nn.Linear(c3 * math.prod(self.pool_out), d)
        self.feature_extractor = fe
        cd = nn.Module()
        cd.causal_net = nn.Sequential(
            nn.Linear(d, m["causal_hidden"]), nn.ReLU(),
            nn.Linear(m["causal_hidden"], d * d), nn.Sigmoid())
        self.causal_discovery = cd
        self.graph_encoder = nn.Sequential(
            nn.Linear(d * d, m["hidden_dim"]), nn.ReLU(), nn.Identity(),
            nn.Linear(m["hidden_dim"], m["graph_embed_dim"]))
        self.anomaly_predictor = nn.Sequential(
            nn.Linear(d + m["graph_embed_dim"], 32), nn.ReLU(),
            nn.Linear(32, 1), nn.Sigmoid())

    def forward(self, x, keep_fc=None, keep_graph=None,
                compute=torch.float32, quant=None):
        """The conv stack and fc in `compute` (parameters cast to it, the
        heads in the parameters' type), each conv's and the fc's input and
        weight through `quant` where it is given."""
        fe = self.feature_extractor
        q = quant or (lambda t: t)
        x = x.to(compute)
        for conv in (fe.conv3d_1, fe.conv3d_2, fe.conv3d_3):
            x = F.relu(F.conv3d(q(x), q(conv.weight.to(compute)),
                                conv.bias.to(compute), conv.stride,
                                conv.padding))
        x = F.adaptive_avg_pool3d(x, self.pool_out).flatten(1)
        feats = F.linear(q(x), q(fe.fc.weight.to(compute)),
                         fe.fc.bias.to(compute))
        if keep_fc is not None:
            feats = torch.where(keep_fc, feats / (1 - self.p), 0.0)
        feats = feats.to(fe.fc.weight.dtype)
        adj = self.causal_discovery.causal_net(feats).view(-1, self.d, self.d)
        adj = adj * (1 - torch.eye(self.d, device=adj.device))
        ge = self.graph_encoder
        g = F.relu(ge[0](adj.flatten(1)))
        if keep_graph is not None:
            g = torch.where(keep_graph, g / (1 - self.p), 0.0)
        g = ge[3](g)
        return self.anomaly_predictor(torch.cat([feats, g], 1)), adj


def loss_fn(scores, adj, targets, c: Mapping):
    """The five terms of ``improved_loss`` on a batch with no padding."""
    p = scores.reshape(-1).clamp(1e-7, 1 - 1e-7)
    ce = -(targets * p.log() + (1 - targets) * (1 - p).log())
    focal = (c["focal_alpha"] * (1 - torch.exp(-ce)) ** c["focal_gamma"]
             * ce).mean()
    mean_adj = adj.mean(0)
    acyc = torch.diagonal(mean_adj @ mean_adj).sum()
    edges = (adj > c["edge_threshold"]).float().sum()
    n, cells = adj.shape[0], adj.shape[1] * adj.shape[2]
    sparsity = (edges / (n * cells) - c["target_sparsity"]).abs()
    normal = targets == 0
    flat = adj.flatten(1)[normal]
    k = flat.shape[0]
    if k > 1:
        dist = torch.cdist(flat, flat, p=1) / flat.shape[1]
        upper = torch.triu(torch.ones(k, k, dtype=torch.bool,
                                      device=flat.device), 1)
        consistency = (dist[upper].mean() - c["consistency_target"]).abs()
    else:
        consistency = adj.new_zeros(())
    lo, hi = c["min_edges"], c["max_edges"]
    structure = ((lo - edges) * 0.01 if edges < lo
                 else (edges - hi) * 0.01 if edges > hi
                 else adj.new_zeros(()))
    return (c["anomaly_weight"] * focal + c["causal_weight"] * acyc
            + c["sparsity_weight"] * sparsity
            + c["consistency_weight"] * consistency
            + c["structure_weight"] * structure)


def step_seed(seed: int, step: int) -> int:
    """The trainer's generator seed of one step."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded through float8 (e4m3) with a per-tensor scale, the
    gradient passed straight through: the precision below bfloat16."""
    scale = 448.0 / t.detach().abs().amax().clamp(min=1e-12)
    rounded = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (rounded - t.detach())


@contextlib.contextmanager
def numerics(tf32: bool):
    cudnn = torch.backends.cudnn
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                         allow_tf32=tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
          mu: List[torch.Tensor], nu: List[torch.Tensor], t: int,
          o: Mapping, lr: float) -> List[torch.Tensor]:
    """Clip to the global norm, then AdamW (decoupled decay on every
    parameter) at `lr`, in place; the clipped gradients the optimizer
    took."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = 1.0 if norm < o["grad_clip"] else o["grad_clip"] / norm
    clipped = [g * scale for g in grads]
    b1, b2 = o["b1"], o["b2"]
    with torch.no_grad():
        for p, g, m, v in zip(params, clipped, mu, nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + 1e-8)
            p.add_(-lr * (u + o["weight_decay"] * p))
    return clipped


class Schedule:
    """The epoch's learning rate by torch's own scheduler of the schedule
    `optim` names, over a one-parameter optimizer: `lr` is the current
    rate, `step(loss)` ends an epoch of mean loss `loss`."""

    def __init__(self, optim: Mapping, num_epochs: int):
        self.opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)],
                                   lr=optim["lr"])
        sched = torch.optim.lr_scheduler
        kind = optim["schedule"]
        if kind == "cosine":
            self.sched = sched.CosineAnnealingLR(
                self.opt, T_max=optim["cosine_steps"] or max(1, num_epochs))
        elif kind == "plateau":
            self.sched = sched.ReduceLROnPlateau(
                self.opt, mode="min", factor=optim["plateau_factor"],
                patience=optim["plateau_patience"], threshold=1e-4,
                threshold_mode="rel", cooldown=0)
        elif kind == "step":
            self.sched = sched.StepLR(self.opt, optim["step_size"],
                                      optim["step_gamma"])
        elif kind == "constant":
            self.sched = None
        else:
            raise ValueError(f"unknown schedule {kind!r}")

    @property
    def lr(self) -> float:
        return self.opt.param_groups[0]["lr"]

    def step(self, loss: float) -> None:
        self.opt.step()  # no gradient: moves nothing
        if isinstance(self.sched, torch.optim.lr_scheduler.ReduceLROnPlateau):
            self.sched.step(loss)
        elif self.sched is not None:
            self.sched.step()


def train_steps(cfg: Mapping, weights: Mapping[str, torch.Tensor],
                batches: Sequence[torch.Tensor], labels, seed: int, device,
                calls: Sequence[int], tf32: bool = False, drop_rows=None,
                compute: str = "float32") -> Dict:
    """The steps of the trainer from `weights` on uint8 `batches` (B, T,
    H, W, C) with the step generators of `seed` (family D trains on
    pseudo-labels: `labels` is unread), as `result` gives them.  The steps
    fall into epochs of `calls` steps each, after each of which the
    schedule of ``cfg['optim']`` steps on the epoch's mean loss.  `compute`
    is the conv stack's precision: 'float32', 'bfloat16' (the port's bf16
    training: convs and fc in bf16, heads in float32) or 'fp8' (bfloat16
    with every conv's and the fc's input and weight rounded by `fp8`).  `drop_rows`, where given, trains
    each step on the rows it keeps (a fault the tests plant)."""
    model = Detector(cfg["model"]).to(device)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    params = [p for p in model.parameters()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses, first, steps = [], None, []
    sched = Schedule(cfg["optim"], cfg["train"]["num_epochs"])
    ends = epoch_ends(calls, len(batches))
    p_drop, rate = cfg["model"]["dropout"], cfg["loss"]["pseudo_anomaly_rate"]
    for t, clips in enumerate(batches):
        clips = clips.to(device)
        b = clips.shape[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(step_seed(seed, t))
        targets = (torch.rand(b, generator=gen, device=device)
                   > 1 - rate).float()
        keep_fc = torch.rand((b, cfg["model"]["causal_dim"]), generator=gen,
                             device=device) >= p_drop
        keep_graph = torch.rand((b, cfg["model"]["hidden_dim"]),
                                generator=gen, device=device) >= p_drop
        x = clips.float().div(255.0).permute(0, 4, 1, 2, 3)
        if drop_rows is not None:
            rows = drop_rows(b)
            x, targets = x[rows], targets[rows]
            keep_fc, keep_graph = keep_fc[rows], keep_graph[rows]
        with numerics(tf32):
            scores, adj = model.train()(
                x, keep_fc, keep_graph,
                torch.float32 if compute == "float32" else torch.bfloat16,
                fp8 if compute == "fp8" else None)
            loss = loss_fn(scores, adj, targets, cfg["loss"])
            grads = torch.autograd.grad(loss, params)
        g = adamw(params, grads, mu, nu, t + 1, cfg["optim"], sched.lr)
        losses.append(float(loss.detach()))
        steps.append([p.detach().clone() for p in params])
        if first is None:
            first = [x.detach().clone() for x in g]
        if t in ends:
            sched.step(sum(losses[ends[t]:]) / (t + 1 - ends[t]))
    names = [n for n, _ in model.named_parameters()]
    return result(names, losses, first, mu, steps, sched.lr)


def epoch_ends(calls: Sequence[int], steps: int) -> Dict[int, int]:
    """The last step of each epoch of `calls` steps, to its first step."""
    if sum(calls) != steps:
        raise ValueError(f"epochs of {list(calls)} steps, not {steps}")
    out, at = {}, 0
    for n in calls:
        out[at + n - 1] = at
        at += n
    return out


def result(names, losses, first, mu, steps, lr) -> Dict:
    """Each step's loss, the clipped gradient of the first step, the first
    moment after the last, the trainable parameters after each step, and
    the learning rate after the last epoch's end."""
    return {"losses": losses, "names": names,
            "first_grad": dict(zip(names, first)),
            "mu_last": {n: m.detach().clone() for n, m in zip(names, mu)},
            "params_steps": [dict(zip(names, ps)) for ps in steps],
            "lr_last": lr}


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the state dict, drawn on `device` in one call from a
    generator seeded with `seed`: U(-1, 1) / sqrt(fan_in), as torch's
    default initialisation bounds conv and Linear weights and biases."""
    shapes = Detector(cfg["model"]).to("meta").state_dict()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    total = sum(v.numel() for v in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    fan = {}
    for name, v in shapes.items():
        if name.endswith("weight"):
            fan[name[:-len("weight")]] = math.prod(v.shape[1:])
    for name, v in shapes.items():
        n = v.numel()
        bound = 1 / math.sqrt(fan[name.rsplit(".", 1)[0] + "."])
        out[name] = (flat[at:at + n] * bound).view(v.shape).contiguous()
        at += n
    return out


def flops_per_clip(cfg: Mapping, train: bool, clips: int = 2) -> float:
    """Operations of one clip (forward, and backward where `train`) as
    `FlopCounterMode` counts the reference's on meta tensors; the clips do
    not take a gradient, as in training."""
    from torch.utils.flop_counter import FlopCounterMode

    m = cfg["model"]
    t, (h, w) = cfg["data"]["clip_len"], cfg["data"]["frame_size"]
    model = Detector(m).to("meta").train()
    x = torch.empty(clips, m["in_channels"], t, h, w, device="meta")
    with FlopCounterMode(display=False) as fc:
        scores, adj = model(x)
        if train:
            (scores.sum() + adj.sum()).backward()
    return fc.get_total_flops() / clips
