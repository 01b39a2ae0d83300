#!/usr/bin/env python3
"""Probe: where the port's family-D train step spends its backward on a
CUDA card, and what cuDNN's settings cost.

    python scripts/probe_torch_backward.py

Run from the root of a checkout on a machine with a CUDA card (it imports
nothing of JAX).  Prints one JSON line per measurement:

- ``k1_weight_grad``: conv1's weight gradient at B=256, T=8, 64x64 in
  float32 and bfloat16, by the unfolded Conv3d's backward
  (``aten.convolution_backward``, what F.conv3d's autograd runs) and by
  the folded conv's backward (`tfold_conv1_backward_reference`, the
  port's), with cuDNN's deterministic algorithms on and off;
- ``train_step``: the family-D train step at B=256 from uint8 clips under
  cuDNN variants (deterministic or not, autotuning or not, convs 2-3 in
  channels-last layout), each with the median of 10 steps (CUDA events)
  and whether two fresh 3-step runs end bit-identical.

The variants replace `cvad_tpu_torch.train.tasks.card_numerics` and
`cvad_tpu_torch.models.family_d._conv` for the probe's own process only.
TF32 stays off throughout.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cvad_tpu_torch.config import preset  # noqa: E402
from cvad_tpu_torch.models import family_d  # noqa: E402
from cvad_tpu_torch.ops.pallas_conv import (  # noqa: E402
    tfold_conv1_backward_reference)
from cvad_tpu_torch.train import tasks  # noqa: E402

B, CLIP = 256, (8, 64, 64, 3)


def cudnn(deterministic: bool, benchmark: bool):
    c = torch.backends.cudnn
    return c.flags(enabled=True, benchmark=benchmark,
                   deterministic=deterministic, allow_tf32=False)


def median_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return statistics.median(out)


def k1_weight_grad(rng: np.random.Generator) -> None:
    x0 = torch.from_numpy(rng.uniform(0, 1, (B, 3) + CLIP[:3])
                          .astype(np.float32)).cuda()
    w0 = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                          .astype(np.float32)).cuda()
    g0 = torch.randn((B, 16, 8, 32, 32), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x, w, g = x0.to(dtype), w0.to(dtype), g0.to(dtype)
        for det in (True, False):
            with cudnn(det, False):
                unfolded = median_ms(lambda: torch.ops.aten.convolution_backward(
                    g, x, w, None, [1, 2, 2], [1, 1, 1], [1, 1, 1], False,
                    [0, 0, 0], 1, [False, True, False]))
                folded = median_ms(lambda: tfold_conv1_backward_reference(
                    g, x, w, (False, True)))
            print(json.dumps({"probe": "k1_weight_grad", "B": B,
                              "dtype": str(dtype).replace("torch.", ""),
                              "deterministic": det,
                              "unfolded_ms": unfolded, "folded_ms": folded}),
                  flush=True)


def train_step(rng: np.random.Generator) -> None:
    clips = torch.from_numpy(rng.integers(0, 256, (B,) + CLIP,
                                          dtype=np.uint8)).cuda()
    batch = {"clips": clips}
    plain_conv = family_d._conv

    def channels_last_conv(conv, x):
        return plain_conv(conv, x.contiguous(
            memory_format=torch.channels_last_3d))

    variants = (("deterministic", True, False, False),
                ("nondeterministic", False, False, False),
                ("deterministic_autotuned", True, True, False),
                ("deterministic_channels_last", True, False, True))
    for dtype in ("float32", "bfloat16"):
        cfg = preset("family_d")
        cfg = cfg.replace(train=cfg.train.replace(dtype=dtype))
        for name, det, bench, channels_last in variants:
            tasks.card_numerics = (lambda det=det, bench=bench:
                                   cudnn(det, bench))
            family_d._conv = channels_last_conv if channels_last \
                else plain_conv
            task = tasks.build_task(cfg)
            state = task.init_state(0, "cuda")

            def step():
                nonlocal state
                state, _ = task.train_step(state, batch, 1)

            ms = median_ms(step)
            ends = []
            for _ in range(2):
                s = task.init_state(0, "cuda")
                for _ in range(3):
                    s, _ = task.train_step(s, batch, 1)
                ends.append(torch.cat([p.detach().reshape(-1)
                                       for p in s.model.parameters()]))
            print(json.dumps({"probe": "train_step", "B": B, "dtype": dtype,
                              "variant": name, "median_ms": ms,
                              "repeat_bit_identical":
                                  bool(torch.equal(*ends))}), flush=True)
    family_d._conv = plain_conv


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_backward: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    rng = np.random.default_rng(0)
    k1_weight_grad(rng)
    train_step(rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
