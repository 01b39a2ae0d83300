#!/usr/bin/env python3
"""Probe: the device time of K2 (`pairwise_l1_mean`, forward and backward
kernels) per call on a CUDA card, for one checkout of the port.

    python scripts/probe_torch_pairwise.py [ROOT]

ROOT (default: this checkout) is the root of the checkout whose
`cvad_tpu_torch` is imported, so that two versions can be compared on one
card in one run: unpack the other commit with ``git archive`` into a
directory `.gitignore` lists and run this script on each, in turns (A, B,
B, A).  Imports nothing of JAX.  Prints one JSON line: the card's name and
power limit, and for each (B, N) in SHAPES the kernels' device time per
call from torch.profiler over ITERS calls of the forward and autograd's
backward, the forward's kernels (every `pairwise_` kernel but the
backward's) and the backward's apart; beside the backward, its bound
(the larger of the bytes it must move at 3.35 TB/s and 3 operations per
masked (i, j, k) at 67 TFLOP/s, as chip_smoke.py counts them), the device
time of autograd's backward of `torch.cdist(p=1)` weighted by the pairs
(the library call for the same gradient, which the port never calls),
and the checkout's backward plan where it has one.  The mask keeps 95% of
the rows, the share of the main path's pseudo-labels.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# the main paths' (train-d, train-d-t64), wide, odd
SHAPES = ((256, 256), (128, 256), (64, 16384), (33, 9000))
ITERS = 50
MASK_RATE = 0.05  # rows out of the mask
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12  # H100 SXM, NVIDIA's data sheet


def device_ms(fn, keep, iters: int) -> float:
    """Device time per call of the CUDA kernels whose names pass `keep`,
    from torch.profiler over `iters` warm calls of `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and keep(e.key)
               ) / 1e3 / iters


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from cvad_tpu_torch.ops import pallas_kernels as pk
    from cvad_tpu_torch.ops.pallas_kernels import pairwise_l1_mean

    if not torch.cuda.is_available():
        print("probe_torch_pairwise: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    out = {"root": str(root), "card": card, "iters": ITERS}
    for b, n in SHAPES:
        flat = torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32))
        mask = rng.uniform(size=b) >= MASK_RATE
        f = flat.cuda().requires_grad_(True)
        m = torch.from_numpy(mask.astype(np.float32)).cuda()

        def call():
            avg, _ = pairwise_l1_mean(f, m)
            torch.autograd.grad(avg, f)

        ms = {part: device_ms(call, lambda k, part=part: "pairwise_" in k
                              and ("backward" in k) == (part == "backward"),
                              ITERS) for part in ("forward", "backward")}
        fr = flat.cuda().requires_grad_(True)
        w = torch.triu(m[:, None] * m[None, :], 1)
        lib_loss = (torch.cdist(fr, fr, p=1) * w).sum()
        rows = float(mask.sum())
        bound = max((2 * b * n + b + 2) * 4 / HBM_BYTES_S,
                    3 * rows * rows * n / F32_OPS_S) * 1e3
        plan = getattr(pk, "pairwise_backward_plan", None)
        out[f"{b}x{n}"] = {
            "forward_device_ms": ms["forward"],
            "backward_device_ms": ms["backward"],
            "backward_bound_ms": bound,
            "cdist_backward_device_ms": device_ms(
                lambda: torch.autograd.grad(lib_loss, fr, retain_graph=True),
                lambda k: True, ITERS),
            "backward_plan": plan(b, n, sms)._asdict() if plan else None}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
