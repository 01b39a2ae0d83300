"""Train state: the model, the optimizer state and the step.

Port of `cvad_tpu/train/state.py`.  There the state is an immutable pytree
threaded through a donated jitted step; here `TrainState` holds the
`nn.Module` whose parameters the train step updates in place, the
optimizer's `OptState` over the flat parameter vector, and ``step``, a host
int: every step advances it by one, skipped or not, so it never needs a
device read (a replay of K captured steps advances it by K).

Every device tensor of the state is written in place: the parameters and
buffers by the step and by `load_state_dict`, the moments, Adam's count and
the learning rate too (`train/tasks.py::_apply_updates`,
`train/optim.py::set_lr`).  A CUDA graph of K train steps
(`train/graphs.py`) reads and writes the addresses it was captured with,
so a restore or an lr change between replays must land in those tensors.  `cvad_tpu` keeps family B's BatchNorm statistics and memory
bank in the state (``batch_stats``, ``extra``); here they are buffers of
the model (``running_mean``/``running_var``, ``normal_memory``,
``memory_ptr``, ``memory_fill``), so ``state_dict`` and
``load_state_dict`` carry them with the weights.  The optimizer works on
the parameters that require a gradient (`trainable`): family A's frozen
stem has no moments and takes no update, as `cvad_tpu`'s masked optax
chain gives it none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping

import torch
from torch import nn

from cvad_tpu_torch.train.optim import OptState


def trainable(model: nn.Module) -> List[torch.Tensor]:
    """The parameters that require a gradient, in `named_parameters`
    order: the flat optimizer vector's."""
    return [p for p in model.parameters() if p.requires_grad]


@dataclass
class TrainState:
    model: nn.Module
    opt_state: OptState
    step: int = 0

    def params(self) -> List[torch.Tensor]:
        """The trainable parameters, in the flat vector's order."""
        return trainable(self.model)

    def state_dict(self) -> dict:
        """Host copies of the model weights (reference `.pth` keys), the
        optimizer state and the step."""
        o = self.opt_state
        return {"model_state_dict": {k: v.detach().cpu().clone() for k, v in
                                     self.model.state_dict().items()},
                "optimizer": {"mu": o.mu.cpu(), "nu": o.nu.cpu(),
                              "count": o.count.cpu(), "lr": o.lr.cpu()},
                "step": int(self.step)}

    @torch.no_grad()
    def load_state_dict(self, d: Mapping) -> None:
        """Inverse of `state_dict`: copied into this state's tensors, on
        their device, so that a captured graph sees the restored state."""
        self.model.load_state_dict(d["model_state_dict"], strict=True)
        o = d["optimizer"]
        for name in ("mu", "nu", "count", "lr"):
            getattr(self.opt_state, name).copy_(o[name])
        self.step = int(d["step"])


def float_metrics(metrics: Mapping[str, torch.Tensor]) -> dict:
    """Device metrics -> host floats (one transfer point)."""
    return {k: float(v) for k, v in metrics.items()}


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
