"""Optimizer and learning-rate schedules, in PyTorch.

Port of `cvad_tpu/train/optim.py`.  There the optimizer is optax's
``chain(clip, inject_hyperparams(adamw | adam))``; here it is a small
functional optimizer over ONE flat float32 vector holding every parameter
(the model's `named_parameters` order, `flatten`), so that each step of the
update is one elementwise op over all parameters, and the NaN guard of the
train step is one device-side select.  It keeps optax's order of arithmetic:

- global norm: sqrt(sum g^2) (optax sums per leaf first; the order of the
  float sum is the only difference);
- ``clip_by_global_norm``: g unchanged when norm < max, else
  g / norm * max, with no epsilon (not ``clip_grad_norm_``'s
  max / (norm + 1e-6));
- ``conditional_clip``: g * (clip_to / max(norm, 1e-16)) when norm > trigger;
- Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count + 1,
  u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + 1e-8);
- adamw: u = -lr (u + wd p), decay on every parameter, biases included;
  adam with wd > 0: g + wd p before the moments (coupled L2);
- the new parameters are p + u.

The learning rate is a float32 tensor in the state.  `set_lr` writes it in
place between epochs, without a host sync: a CUDA graph of K train steps
(`train/graphs.py`) reads the tensors it was captured with at every
replay, so a new tensor would go unseen.  `HostScheduler` is the same plain
Python as `cvad_tpu`'s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from cvad_tpu_torch.config import OptimConfig


def flatten(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Concatenate tensors into one flat float32 vector."""
    return torch.cat([t.reshape(-1).float() for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Views of `flat` shaped like `like` (inverse of `flatten`)."""
    sizes = [t.numel() for t in like]
    return [v.view(t.shape) for v, t in zip(flat.split(sizes), like)]


def global_norm(flat: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum of squares (`optax.global_norm`)."""
    return torch.sqrt(torch.sum(flat * flat))


@dataclass
class OptState:
    """Adam's moments over the flat parameter vector, its step count
    (int32, as optax's) and the injected learning rate (float32)."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor
    lr: torch.Tensor

    def to(self, device) -> "OptState":
        return OptState(*(t.to(device) for t in
                          (self.mu, self.nu, self.count, self.lr)))


class Optimizer:
    """clip -> Adam/AdamW with an injected lr, over flat vectors."""

    def __init__(self, cfg: OptimConfig):
        if cfg.optimizer not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg

    def init(self, params: torch.Tensor) -> OptState:
        dev = params.device
        return OptState(mu=torch.zeros_like(params),
                        nu=torch.zeros_like(params),
                        count=torch.zeros((), dtype=torch.int32, device=dev),
                        lr=torch.full((), self.cfg.lr, dtype=torch.float32,
                                      device=dev))

    def clip(self, grads: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
        """The configured clip of the flat gradient whose global norm is
        `norm`."""
        cfg = self.cfg
        if cfg.grad_clip <= 0:
            return grads
        if cfg.clip_trigger > 0:
            return conditional_clip(grads, norm, cfg.clip_trigger,
                                    cfg.grad_clip)
        return clip_by_global_norm(grads, norm, cfg.grad_clip)

    def update(self, grads: torch.Tensor, state: OptState,
               params: torch.Tensor, norm: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, OptState]:
        """(updates, new state) for flat `grads` at flat `params`; `norm`
        is the global norm of `grads` when the caller has it."""
        cfg = self.cfg
        if norm is None:
            norm = global_norm(grads)
        g = self.clip(grads, norm)
        if cfg.optimizer == "adam" and cfg.weight_decay > 0:
            g = g + cfg.weight_decay * params
        mu = (1 - cfg.b1) * g + cfg.b1 * state.mu
        nu = (1 - cfg.b2) * (g * g) + cfg.b2 * state.nu
        count = state.count + 1
        c = count.float()
        mu_hat = mu / (1 - torch.pow(torch.full_like(c, cfg.b1), c))
        nu_hat = nu / (1 - torch.pow(torch.full_like(c, cfg.b2), c))
        u = mu_hat / (torch.sqrt(nu_hat) + 1e-8)
        if cfg.optimizer == "adamw":
            u = u + cfg.weight_decay * params
        u = u * (-state.lr)
        return u, OptState(mu=mu, nu=nu, count=count, lr=state.lr)


def clip_by_global_norm(grads: torch.Tensor, norm: torch.Tensor,
                        max_norm: float) -> torch.Tensor:
    """`optax.clip_by_global_norm`: g when norm < max_norm, else
    g / norm * max_norm."""
    return torch.where(norm < max_norm, grads, grads / norm * max_norm)


def conditional_clip(grads: torch.Tensor, norm: torch.Tensor, trigger: float,
                     clip_to: float) -> torch.Tensor:
    """The family-C clip: untouched unless the global norm exceeds
    `trigger`, then rescaled to `clip_to`."""
    scale = torch.where(norm > trigger,
                        clip_to / torch.clamp(norm, min=1e-16),
                        torch.ones_like(norm))
    return grads * scale


def build_optimizer(cfg: OptimConfig) -> Optimizer:
    """Grad clip + Adam/AdamW with an injected lr."""
    return Optimizer(cfg)


def get_lr(state: OptState) -> float:
    """The current learning rate (a host read of one float)."""
    return float(state.lr)


def set_lr(state: OptState, lr: float) -> OptState:
    """`state` with its learning rate set to `lr` in place (a device fill,
    no sync), so that a captured train-step graph reads the new value."""
    state.lr.fill_(lr)
    return state


class HostScheduler:
    """Epoch-granular lr scheduler with torch's semantics:
    ReduceLROnPlateau (mode 'min', relative threshold 1e-4, no cooldown),
    StepLR, CosineAnnealingLR and constant.  `step(metric)` is called once
    per epoch and returns the new lr."""

    def __init__(self, cfg: OptimConfig, total_epochs: int = 0):
        self.cfg = cfg
        self.base_lr = cfg.lr
        self.lr = cfg.lr
        self.epoch = 0
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.total_epochs = total_epochs

    def step(self, metric: Optional[float] = None) -> float:
        cfg = self.cfg
        self.epoch += 1
        if cfg.schedule == "constant":
            pass
        elif cfg.schedule == "plateau":
            if metric is not None and math.isfinite(metric):
                if self.best is None or metric < self.best * (1 - 1e-4):
                    self.best = metric
                    self.bad_epochs = 0
                else:
                    self.bad_epochs += 1
                    if self.bad_epochs > cfg.plateau_patience:
                        self.lr = self.lr * cfg.plateau_factor
                        self.bad_epochs = 0
        elif cfg.schedule == "step":
            if self.epoch % cfg.step_size == 0:
                self.lr = self.lr * cfg.step_gamma
        elif cfg.schedule == "cosine":
            t_max = cfg.cosine_steps or max(1, self.total_epochs)
            self.lr = 0.5 * self.base_lr * (
                1 + math.cos(math.pi * self.epoch / t_max))
        else:
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "epoch": self.epoch, "best": self.best,
                "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.epoch = d["epoch"]
        self.best = d["best"]
        self.bad_epochs = d["bad_epochs"]
