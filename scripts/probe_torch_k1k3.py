#!/usr/bin/env python3
"""Probe: the device time of K1 (the T-folded conv1) and K3 (the memory-bank
min cosine distance) per call on a CUDA card, for one checkout of the port.

    python scripts/probe_torch_k1k3.py [ROOT]

ROOT (default: this checkout) is the root of the checkout whose
`cvad_tpu_torch` is imported, so that two versions can be compared on one
card in one run: unpack the other commit with ``git archive`` into a
directory `.gitignore` lists and run this script on each, in turns (A, B,
B, A).  Imports nothing of JAX.  Prints one JSON line: the card's name and
power limit, and

- K1 through `tfold_conv1` at K1_SHAPES (B, T) on 64x64 clips, float32
  and bfloat16, and F.conv3d on the same conv (the library yardstick the
  port never calls);
- K3 through `memory_min_cosine_distance` at K3_SHAPES (B, M, D) with a
  full bank, and the library expression F.normalize + torch.mm +
  torch.where + amin;

each as the card's time alone per call (`device_ms`: CUDA events around
ITERS calls queued behind a spin kernel, the gaps between a call's
kernels included, as chip_smoke.py's device_ms), the mean of CUDA events
around back-to-back calls beside it (`event_ms`, which the host bounds at
small shapes), and the bound from the call's bytes
(each input read once, each output written once) and operations at the
H100 SXM's peaks (3.35 TB/s; 67 TFLOP/s float32, 989 bf16).  Inputs come
from ``numpy.random.default_rng(0)``; TF32 stays off.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

K1_SHAPES = ((1, 8), (8, 8), (256, 8), (128, 64))
K3_SHAPES = ((256, 500, 64), (1024, 4096, 128), (16, 500, 2048),
             (8, 64, 4096), (16, 500, 128))
ITERS = 30
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def device_ms(fn, iters: int) -> float:
    """The card's time alone per call of `fn`: CUDA events around `iters`
    calls queued behind a spin kernel (`torch.cuda._sleep`), so that they
    time the card running the calls back to back (the gaps between their
    kernels included) and not the host issuing them, as chip_smoke.py's
    device_ms does."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(5):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / iters
        cycles *= 4
    raise RuntimeError("the host did not queue the timed calls ahead of the "
                       "card")


def event_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / peak) * 1e3


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1
    from cvad_tpu_torch.ops.pallas_kernels import memory_min_cosine_distance

    if not torch.cuda.is_available():
        print("probe_torch_k1k3: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    out = {"root": str(root), "card": card, "iters": ITERS, "k1": [],
           "k3": []}
    w32 = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                           .astype(np.float32)).cuda()
    for b, t in K1_SHAPES:
        x32 = torch.from_numpy(rng.uniform(0, 1, (b, 3, t, 64, 64))
                               .astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            name = str(dtype).replace("torch.", "")
            y = tfold_conv1(x, w)

            def kernel():
                return tfold_conv1(x, w)

            def library():
                return F.conv3d(x, w, stride=(1, 2, 2), padding=1)

            nbytes = (x.numel() + w.numel() + y.numel()) * x.element_size()
            out["k1"].append({
                "B": b, "T": t, "dtype": name,
                "device_ms": device_ms(kernel, ITERS),
                "event_ms": event_ms(kernel, ITERS),
                "library_device_ms": device_ms(library, ITERS),
                "library_event_ms": event_ms(library, ITERS),
                "bound_ms": bound_ms(nbytes, 2 * 81 * y.numel(),
                                     PEAK_FLOPS[name])})
            del x, w, y
        del x32
        torch.cuda.empty_cache()

    def library_k3(q, mem, f):
        sims = torch.mm(F.normalize(q, dim=1, eps=1e-8),
                        F.normalize(mem, dim=1, eps=1e-8).T)
        col = torch.arange(mem.shape[0], device=q.device)
        dist = torch.where(col[None, :] < f, 1.0 - sims.clamp(-1.0, 1.0),
                           3.0)
        return dist.amin(dim=1).clamp(0.0, 2.0) / 2.0

    for b, m, d in K3_SHAPES:
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)
                             ).cuda()
        mem = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)
                               ).cuda()
        f = torch.tensor(m, dtype=torch.int32, device="cuda")
        out["k3"].append({
            "B": b, "M": m, "D": d,
            "device_ms": device_ms(
                lambda: memory_min_cosine_distance(q, mem, f), ITERS),
            "event_ms": event_ms(
                lambda: memory_min_cosine_distance(q, mem, f), ITERS),
            "library_device_ms": device_ms(lambda: library_k3(q, mem, f),
                                           ITERS),
            "library_event_ms": event_ms(lambda: library_k3(q, mem, f),
                                         ITERS),
            "bound_ms": bound_ms(((b + m) * d + b + 1) * 4, 2 * b * m * d,
                                 PEAK_FLOPS["float32"])})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
