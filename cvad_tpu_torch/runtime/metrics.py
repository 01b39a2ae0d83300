"""Structured metric stream, spans and the profiler trace.

Port of `cvad_tpu/runtime/metrics.py` (`MetricLogger`, `profile_trace`):
an append-only JSONL stream with a console echo, and a `torch.profiler`
trace (``train --profile-dir``) in place of `jax.profiler`'s.  `span`
names a range of the program (the trainer's and the batching server's
layers) on the profiler's clock, so that a trace puts each of the card's
idle gaps down to the range the host was in; with no profiler running it
costs a shared no-op context.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """`torch.profiler.record_function(name)` while a profiler runs in the
    process, else a shared no-op context (a bare `record_function` costs
    ~20 times as much on the host).  The test is torch's process-wide
    flag: ``torch.autograd._profiler_enabled()`` is per thread, and reads
    False in the batching worker even where the profile records every
    thread."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


TRACE_NAME = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str, device=None) -> Iterator[Any]:
    """Profile the block with `torch.profiler` and write a Chrome trace to
    ``log_dir/trace.json``: CPU activity of every thread (the prefetcher's
    and the batching worker's too, threads that were started before the
    profile), and CUDA activity where `device` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=acts, experimental_config=every_thread) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / TRACE_NAME))
