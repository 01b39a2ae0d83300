"""Family D's train and eval steps, in PyTorch.

Port of `cvad_tpu/train/tasks.py` for family D (`prep_clips`,
`_apply_updates`, `_family_d_task`).  Batches are dicts of tensors already
on the model's device: ``{"clips": (B, T, H, W, C) uint8 or float32,
"labels": (B,)}``, optionally ``"valid"`` (B,) and ``"pseudo_targets"``
(B,).

Randomness: `cvad_tpu` derives each step's dropout and pseudo-label keys
from ``fold_in(rng, step)``, which is stateless, so a resumed run replays
them.  Here each step seeds a fresh `torch.Generator` on the device from
(seed, step) (`step_seed`) and draws the pseudo-labels, then the dropout
masks, from it; no generator state is carried between steps.  The two
frameworks draw different bits from the same seed: tests set dropout to 0
and pass ``pseudo_targets``.

Numerics on the card: the steps run inside ``cudnn.flags(deterministic=True,
allow_tf32=False, benchmark=False)``.  TF32 (cuDNN's default for float32
convolutions and their backward) keeps about three decimal digits, and the
deterministic algorithms make repeated runs, and so a resumed run,
bit-identical.  ``torch.backends.cuda.matmul.allow_tf32`` stays at its
default, False.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch

from cvad_tpu_torch.config import ExperimentConfig
from cvad_tpu_torch.evaluation import scoring
from cvad_tpu_torch.models import CausalAnomalyDetector
from cvad_tpu_torch.ops.losses import improved_loss, pseudo_labels
from cvad_tpu_torch.runtime.device import resolve_device
from cvad_tpu_torch.train.optim import (OptState, Optimizer, build_optimizer,
                                        flatten, global_norm, unflatten)
from cvad_tpu_torch.train.state import TrainState


class Task:
    """Model config, optimizer and the step functions of one family."""

    def __init__(self, model_cfg, tx: Optimizer, init_state: Callable,
                 train_step: Callable, eval_step: Callable):
        self.model_cfg = model_cfg
        self.tx = tx
        self.init_state = init_state
        self.train_step = train_step
        self.eval_step = eval_step


def prep_clips(clips: torch.Tensor, clamp=(0.0, 1.0)) -> torch.Tensor:
    """(B, T, H, W, C) uint8 pixels or floats on the device -> float32
    (B, C, T, H, W): uint8 / 255 there (the 4x-smaller transfer), then the
    family-B clamp when it is not (0, 1)."""
    x = scoring.prep_clips(clips)
    lo, hi = clamp
    if (lo, hi) != (0.0, 1.0):
        x = torch.clamp(x, lo, hi)
    return x


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step: `seed` in the high 31 bits, the step
    in the low 32 (the counterpart of ``fold_in(key(seed), step)``)."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def card_numerics():
    """cuDNN without TF32, with deterministic algorithms and no autotuning
    (see the module docstring); a no-op for CPU tensors."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=False, deterministic=True,
                   allow_tf32=False)


@torch.no_grad()
def _apply_updates(state: TrainState, tx: Optimizer,
                   grads: Sequence[torch.Tensor], loss: torch.Tensor
                   ) -> TrainState:
    """Clip + optimizer update under the NaN guard: a non-finite loss or
    raw-gradient norm leaves the parameters, both moments and Adam's count
    untouched (one device-side select, no host branch); ``step`` advances
    either way."""
    params = state.params()
    p = flatten(params)
    g = flatten(grads)
    norm = global_norm(g)
    updates, new = tx.update(g, state.opt_state, p, norm)
    ok = torch.isfinite(loss) & torch.isfinite(norm)
    old = state.opt_state
    torch._foreach_copy_(params, unflatten(torch.where(ok, p + updates, p),
                                           params))
    state.opt_state = OptState(mu=torch.where(ok, new.mu, old.mu),
                               nu=torch.where(ok, new.nu, old.nu),
                               count=torch.where(ok, new.count, old.count),
                               lr=old.lr)
    state.step += 1
    return state


def _family_d_task(cfg: ExperimentConfig) -> Task:
    model_cfg = cfg.model
    if cfg.train.dtype != "float32" and model_cfg.dtype == "float32":
        model_cfg = model_cfg.replace(dtype=cfg.train.dtype)
    tx = build_optimizer(cfg.optim)
    loss_cfg = cfg.loss
    clamp = cfg.data.normalize_clamp

    def init_state(seed: int, device=None) -> TrainState:
        """Fresh parameters from `seed` (torch's default initialisation,
        drawn on the CPU without touching the global generator), on CUDA
        unless `device` says 'cpu'."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = CausalAnomalyDetector(model_cfg)
        model = model.to(resolve_device(device))
        return TrainState(model, tx.init(flatten(model.parameters())
                                         .detach()))

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step; updates `state` in place and returns it with the
        step's metrics as 0-d device tensors."""
        model = state.model
        clips = prep_clips(batch["clips"], clamp)
        valid = batch.get("valid")
        gen = torch.Generator(device=clips.device)
        gen.manual_seed(step_seed(seed, state.step))
        if "pseudo_targets" in batch:
            targets = batch["pseudo_targets"]
        else:
            targets = pseudo_labels(gen, clips.shape[0],
                                    loss_cfg.pseudo_anomaly_rate,
                                    clips.device)
        params = state.params()
        with card_numerics():
            scores, adj, _ = model.train()(clips, generator=gen)
            total, comps = improved_loss(scores, adj, targets, loss_cfg,
                                         valid=valid)
            grads = torch.autograd.grad(total, params)
        state = _apply_updates(state, tx, grads, total.detach())
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in comps.items()}}
        return state, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        clips = prep_clips(batch["clips"], clamp)
        with card_numerics():
            scores, adj, feats = state.model.eval()(clips)
        return {"predictions": scores.reshape(-1), "causal_graphs": adj,
                "features": feats}

    return Task(model_cfg, tx, init_state, train_step, eval_step)


def build_task(cfg: ExperimentConfig) -> Task:
    """The family-D task (the only family ported)."""
    return _family_d_task(cfg)
