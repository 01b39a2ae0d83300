#!/usr/bin/env python3
"""Probe: the device time of K6 (flash attention: forward, dQ and dK/dV
kernels) per call on a CUDA card, for one checkout of the port.

    python scripts/probe_torch_flash.py [ROOT]

ROOT (default: this checkout) is the root of the checkout whose
`cvad_tpu_torch` is imported, so that two versions can be compared on one
card in one run: unpack the other commit with ``git archive`` into a
directory `.gitignore` lists and run this script on each, in turns (A, B,
B, A).  Imports nothing of JAX.  Prints one JSON line: the card's name and
power limit, and for each (B, H, T, Dh) in SHAPES (chip_smoke.py's
FLASH_TIMES), float32 and bfloat16, not causal (as the model runs it), the
device time per call of each kernel from torch.profiler over ITERS calls
(the kernels' own launch functions, as chip_smoke.py times them), and the
same for `F.scaled_dot_product_attention`'s forward and backward (all
three gradients), the library yardstick the port never calls, with the
names of the kernels it ran (which SDPA backend it took).  Inputs are
standard normal from ``numpy.random.default_rng(0)``; TF32 stays off.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((16, 1, 128, 128), (8, 1, 2048, 128), (16, 1, 128, 256))
ITERS = 50


def device_ms(fn, iters: int, names, seen: list = None) -> float:
    """Device time per call of `fn`, summed over the kernels whose names
    contain one of `names` (every kernel when `names` is empty); the names
    of the kernels counted go to `seen`, busiest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and (not names or any(n in e.key for n in names))),
                  reverse=True)
    if seen is not None:
        seen.extend(key[:100] for _, key in rows)
    return sum(t for t, _ in rows) / 1e3 / iters


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cvad_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("probe_torch_flash: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    out = {"root": str(root), "card": card, "iters": ITERS, "shapes": []}
    for shape in SHAPES:
        b, h, t, dh = shape
        scale = dh ** -0.5
        iters = ITERS if t <= 128 else 10
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
                for _ in range(4))
            o, lse = fa._launch_forward(q, k, v, False, scale)
            _, dvec = fa._launch_dq(q, k, v, o, lse, do, False, scale)
            xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            y = F.scaled_dot_product_attention(*xs, scale=scale)
            lib_fwd, lib_bwd = [], []
            row = {"shape": list(shape),
                   "dtype": str(dtype).replace("torch.", ""),
                   "forward_device_ms": device_ms(
                       lambda: fa._launch_forward(q, k, v, False, scale),
                       iters, ("flash_fwd_kernel",)),
                   "dq_device_ms": device_ms(
                       lambda: fa._launch_dq(q, k, v, o, lse, do, False,
                                             scale),
                       iters, ("flash_bwd_dq_kernel",)),
                   "dkv_device_ms": device_ms(
                       lambda: fa._launch_dkv(q, k, v, do, lse, dvec, False,
                                              scale),
                       iters, ("flash_bwd_dkv_kernel",)),
                   "library_forward_device_ms": device_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, scale=scale), iters, (), lib_fwd),
                   "library_backward_device_ms": device_ms(
                       lambda: torch.autograd.grad(y, xs, do,
                                                   retain_graph=True),
                       iters, (), lib_bwd),
                   "library_kernels": {"forward": lib_fwd,
                                       "backward": lib_bwd}}
            row["backward_device_ms"] = (row["dq_device_ms"]
                                         + row["dkv_device_ms"])
            out["shapes"].append(row)
            del q, k, v, do, o, lse, dvec, xs, y
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
