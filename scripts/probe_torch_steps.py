#!/usr/bin/env python3
"""Probe: the per-step median of the train paths whose steps call the
port's kernels, eager and as one captured CUDA graph of 16 steps, for one
checkout of the port on a CUDA card.

    python scripts/probe_torch_steps.py [ROOT] [PATH ...]

ROOT (default: this checkout) is the root of the checkout whose
`chip_smoke.py` and `cvad_tpu_torch` are imported, so that two versions can
be compared on one card in one run: unpack the other commit with ``git
archive`` into a directory `.gitignore` lists and run this script on each,
in turns (A, B, B, A).  It runs `chip_smoke.train_step_times` (CUDA events
around each of 20 calls after warm-up, per optimizer step; device time
from torch.profiler over one call) for the paths d (K1 and K2 in the
step), d64 (K5 and K2), b_attn (K6) and c (no kernel of the port), float32
and bfloat16, at K = 1 and 16, from ``numpy.random.default_rng(22)``; PATH names other paths of
`chip_smoke.step_config` in their place (b, a: families B and A, whose
steps run the BatchNorm statistics).
Imports nothing of JAX.  Prints one JSON line: the card's name and power
limit, the checkout, and a row a path, type and K.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

PATHS = ("d", "d64", "b_attn", "c")
KS = (1, 16)


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    paths = tuple(sys.argv[2:]) or PATHS
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("probe_torch_steps: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rng = np.random.default_rng(22)
    rows = []
    for path in paths:
        for dtype in ("float32", "bfloat16"):
            for k in KS:
                t = chip_smoke.train_step_times(rng, dtype, path, k)
                rows.append({key: t[key] for key in (
                    "family", "dtype", "K", "median_ms", "min_ms", "max_ms",
                    "device_ms_per_step")}
                    | {"busy": t["breakdown"]["device_busy_share"]})
                torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": str(root), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
