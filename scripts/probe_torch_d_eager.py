#!/usr/bin/env python3
"""Probe: where family D's float32 eager train step spends the time it does
not spend on the card, for one checkout of the port on a CUDA card.

    python scripts/probe_torch_d_eager.py [ROOT] [--direct]

ROOT (default: this checkout) is the root whose `chip_smoke.py` and
`cvad_tpu_torch` are imported, so that two commits can be compared on one
card in one run (unpack the other with ``git archive`` into a directory
`.gitignore` lists; run A, B, A, B, ...).  ``--direct`` makes K1's autograd
Function call the kernel's launcher itself, around its custom op, where the
checkout has that op.

On the path 'd' of `chip_smoke.step_config` (B=256, 8 x 64 x 64 x 3,
float32), from ``numpy.random.default_rng(22)``, after 3 warm-up steps it
measures

- CALLS eager steps, each between two synchronizes: the step's time by
  CUDA events and the host's time to issue it (the call's return on the
  host clock): if the host issues the whole step before the card is done,
  the step is the card's time;
- one step under torch.profiler: the card's busy time, and the host's
  synchronizing runtime calls, copies and launches by name and count, with
  the top ops by host self time;
- K1's host time a call at B=1 over 2,000 calls, through its op and
  through the launcher alone (``op_us``, ``launch_us``), where the
  checkout has the op.

Imports nothing of JAX.  Prints one JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = 100
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy",
              "cudaLaunchKernel", "cuLaunchKernel", "cudaMallocAsync",
              "cudaMalloc", "cudaFree", "cudaStreamWaitEvent")


def pct(xs, q):
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def k1_host_us(torch, pallas_conv) -> dict:
    """K1's host microseconds a call at B=1 (the kernel's own time is a
    few microseconds there, so the host sets the pace)."""
    x = torch.rand((1, 3, 8, 64, 64), device="cuda")
    w = torch.rand((16, 3, 3, 3, 3), device="cuda")
    out = {}
    fns = {"launch_us": lambda: pallas_conv._launch(x, w)}
    if hasattr(pallas_conv, "tfold_conv1_forward"):
        fns["op_us"] = lambda: pallas_conv.tfold_conv1_forward(x, w)
    for name, fn in fns.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 2000 * 1e6
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    direct = "--direct" in sys.argv
    root = Path(args[0] if args
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from cvad_tpu_torch.ops import pallas_conv
    from cvad_tpu_torch.train.tasks import build_task

    if not torch.cuda.is_available():
        print("probe_torch_d_eager: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if direct:
        def forward(ctx, x, weight):
            ctx.save_for_backward(x, weight)
            return pallas_conv._launch(x, weight)
        pallas_conv._TFoldConv1.forward = staticmethod(forward)

    rng = np.random.default_rng(22)
    cfg, batch_size, clip = chip_smoke.step_config("d", "float32")
    task = build_task(cfg)
    state = task.init_state(0, "cuda")
    batch = chip_smoke.step_batches(rng, 1, batch_size, clip)[0]

    def call():
        nonlocal state
        state, _ = task.train_step(state, batch, 1)

    for _ in range(3):
        call()
    step_ms, issue_ms = [], []
    for _ in range(CALLS):
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        call()
        stop.record()
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        step_ms.append(start.elapsed_time(stop))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    device_ms = sum(e.device_time_total for e in avgs
                    if e.device_type == DeviceType.CUDA) / 1e3
    runtime = {e.key: {"count": e.count,
                       "cpu_ms": e.cpu_time_total / 1e3}
               for e in avgs if e.key in SYNC_NAMES}
    cpu_top = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)[:15]
    print(json.dumps({
        "card": card, "root": str(root), "direct": direct,
        "torch": torch.__version__,
        "step_ms": {"median": statistics.median(step_ms),
                    "min": min(step_ms), "p10": pct(step_ms, 0.1),
                    "p90": pct(step_ms, 0.9), "max": max(step_ms)},
        "issue_ms": {"median": statistics.median(issue_ms),
                     "min": min(issue_ms), "p90": pct(issue_ms, 0.9),
                     "max": max(issue_ms)},
        "profiled": {"wall_ms": wall_ms, "device_ms": device_ms,
                     "runtime": runtime,
                     "cpu_self_top": [{"name": e.key[:60], "count": e.count,
                                       "self_ms": e.self_cpu_time_total / 1e3}
                                      for e in cpu_top]},
        "k1_host": k1_host_us(torch, pallas_conv)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
