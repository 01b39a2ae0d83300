"""Train state: the model, the optimizer state and the step.

Port of `cvad_tpu/train/state.py`.  There the state is an immutable pytree
threaded through a donated jitted step; here `TrainState` holds the
`nn.Module` whose parameters the train step updates in place, the
optimizer's `OptState` over the flat parameter vector, and ``step``, a host
int: every step advances it by one, skipped or not, so it never needs a
device read.  `cvad_tpu` keeps family B's BatchNorm statistics and memory
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

    def load_state_dict(self, d: Mapping) -> None:
        """Inverse of `state_dict`, onto this state's device."""
        self.model.load_state_dict(d["model_state_dict"], strict=True)
        dev = self.opt_state.mu.device
        o = d["optimizer"]
        self.opt_state = OptState(mu=o["mu"], nu=o["nu"], count=o["count"],
                                  lr=o["lr"]).to(dev)
        self.step = int(d["step"])


def float_metrics(metrics: Mapping[str, torch.Tensor]) -> dict:
    """Device metrics -> host floats (one transfer point)."""
    return {k: float(v) for k, v in metrics.items()}


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
