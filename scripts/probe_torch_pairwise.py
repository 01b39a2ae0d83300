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
backward's) and the backward's apart.  The mask keeps 95% of the rows,
the share of the main path's pseudo-labels.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((256, 256), (64, 16384), (33, 9000))  # the main path's, wide, odd
ITERS = 50
MASK_RATE = 0.05  # rows out of the mask


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvad_tpu_torch.ops.pallas_kernels import pairwise_l1_mean

    if not torch.cuda.is_available():
        print("probe_torch_pairwise: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                call()
            torch.cuda.synchronize()
        fwd = bwd = 0.0
        for e in prof.key_averages():
            if "pairwise_" in e.key:
                ms = e.device_time_total / 1e3 / ITERS
                if "backward" in e.key:
                    bwd += ms
                else:
                    fwd += ms
        out[f"{b}x{n}"] = {"forward_device_ms": fwd,
                           "backward_device_ms": bwd}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
