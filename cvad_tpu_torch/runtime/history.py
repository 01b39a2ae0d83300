"""Training history in the reference's JSON schema.

Port of `cvad_tpu/runtime/history.py`: keys ``train_losses``,
``loss_components``, ``evaluation_metrics``, ``epochs`` and
``learning_rates``, key for key, so history files of the two packages
compare and the reference's diagnosis and plot tooling reads both.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

from cvad_tpu_torch.utils.json_utils import safe_json_load, safe_json_save


class TrainingHistory:
    """Accumulates per-epoch training records and persists them as JSON."""

    KEYS = ("train_losses", "loss_components", "evaluation_metrics", "epochs",
            "learning_rates")

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self.data: Dict[str, List[Any]] = {k: [] for k in self.KEYS}

    def record_epoch(self, epoch: int, train_loss: float,
                     loss_components: Mapping[str, float], lr: float) -> None:
        self.data["epochs"].append(int(epoch))
        self.data["train_losses"].append(float(train_loss))
        self.data["loss_components"].append(
            {k: float(v) for k, v in loss_components.items()})
        self.data["learning_rates"].append(float(lr))
        self._flush()

    def record_eval(self, eval_metrics: Mapping[str, float]) -> None:
        self.data["evaluation_metrics"].append(
            {k: float(v) for k, v in eval_metrics.items()})
        self._flush()

    def _flush(self) -> None:
        if self.path is not None:
            safe_json_save(self.data, self.path, verbose=False)

    @classmethod
    def load(cls, path: str) -> "TrainingHistory":
        h = cls(path)
        loaded = safe_json_load(path)
        if loaded:
            for k in cls.KEYS:
                h.data[k] = list(loaded.get(k, []))
        return h

    @property
    def last_epoch(self) -> int:
        return self.data["epochs"][-1] if self.data["epochs"] else 0

    def as_dict(self) -> Dict[str, List[Any]]:
        return self.data
