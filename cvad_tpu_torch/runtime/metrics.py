"""Structured metric stream and step timing.

Port of `cvad_tpu/runtime/metrics.py` (`MetricLogger`, `StepTimer`): an
append-only JSONL stream with a console echo, and host-clock step timing.
The JAX profiler hook (`profile_trace`, ``--profile-dir``) is not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from cvad_tpu_torch.utils.json_utils import convert_to_json_serializable


class MetricLogger:
    """Append-only JSONL metric writer with optional console echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def log(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = {"t": round(time.time() - self._t0, 3), "kind": kind}
        rec.update(convert_to_json_serializable(dict(fields)))
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            body = " ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("t", "kind"))
            print(f"[{rec['t']:9.2f}s] {kind}: {body}")
        return rec


class StepTimer:
    """Per-step host-clock timing with an ETA.  The clock sees when a step
    was enqueued, not when the card finished it."""

    def __init__(self, total_steps: int = 0):
        self.total_steps = total_steps
        self.count = 0
        self.started = time.time()
        self._last = self.started

    def tick(self) -> Dict[str, float]:
        now = time.time()
        dt = now - self._last
        self._last = now
        self.count += 1
        elapsed = now - self.started
        rate = self.count / elapsed if elapsed > 0 else 0.0
        eta = ((self.total_steps - self.count) / rate
               if rate > 0 and self.total_steps else 0.0)
        return {"step_time_s": dt, "elapsed_s": elapsed, "steps_per_s": rate,
                "eta_s": eta}
