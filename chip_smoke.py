#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`cvad_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc under /usr/local/cuda (or on PATH) and PyTorch built for CUDA.  It
imports nothing of JAX or of `cvad_tpu`.  Every phase prints one JSON line;
any failure raises and the script exits non-zero before the last line.

Phases:
  device   card name, count, and its name and power limit from nvidia-smi
  build    nvcc of every cvad_tpu_torch/csrc/*.cu (one process each, all
           started together), with the -Xptxas -v report
  kernels  each kernel against its plain PyTorch version on the card:
           tfold_conv1 at B in {1, 3, 128, 256}, T=8, 64x64, C=3, O=16,
           and at (B, T, H, W) in K1_EDGE (odd H and W, T=1, T=64, a
           second call bit-identical);
           float32 within atol 1e-4, bfloat16 within |err| <= 1e-2*|ref|
           + 1e-5 against the plain version in float32 on the same
           bf16-rounded inputs;
           tfold_conv1's autograd gradient (x and weight, f32 and bf16, B=4)
           against autograd through the plain version: f32 within 1e-5 of
           the largest |ref|, bf16 within 2e-2 of it;
           conv1 at widths K1 does not take (C=1 -> 16, 3 -> 32): F.conv3d,
           no K1 launch, output and weight gradient against the plain
           folded conv;
           pairwise_l1 forward and backward at B in {1, 2, 33, 256}, N in
           {1, 7, 256}, at (B, N) = (64, 16384) and (33, 9000) (many
           512-wide chunks, ragged 16-row tiles), and at the backward
           plan's edges PAIR_PLAN_EDGES (B in {8, 16, 17, 31, 32, 128, 257}
           at N = 256, and (37, 1001)), masks all zero / single / random /
           all one: avg within rtol 1e-5 (atol 1e-7), n_pairs exact,
           gradient within atol 1e-6, and a second call bit-identical; the
           backward's plans take one split of rows j and many, 16- and
           4-byte staging;
           memory_min_cosine at B x M x D over {1..1024} x {1..4096} x
           {64, 128}, at (16, 500, 2048), (8, 64, 4096), and at its tile
           edges MEM_EDGE (B, M, D no multiple of a tile, D = 1025, 2048,
           4096, fills inside a bank tile, a NaN query row each): within
           1e-6, a second call bit-identical; every plan kind (tile,
           split of D, 16- or 4-byte pieces) taken
  model    the family-D checkpoint scores 128 clips on the card (float32,
           TF32 off) and on the CPU: scores and adjacency within atol 1e-4
  serve    (main path 1) HTTP server on an ephemeral port, buckets
           1,8,32,128, warmed up; npz float32 requests of N=1, 5, 32, a uint8
           one of N=8, two of them concurrent; every score within 1e-5 of
           the direct scorer; /healthz and /stats answer
  bulk     (main path 1) the bf16 bulk scorer on 2,048 clips in chunks of
           256, within 2e-2 of the float32 scorer
  train_parity  the fixture checkpoint, 3 float32 train steps at B=16 with
           dropout 0 and injected pseudo-labels on the card and on the CPU:
           every step's loss and components within rtol 1e-4, parameters
           within 5e-5; each step launches K1 and K2 forward and backward
           once
  train    (main path 2) `Trainer.fit` on the card, float32, B=256, 1,024
           synthetic train clips and 256 eval clips, uint8 transfer, 3
           epochs, eval every epoch, checkpoints every epoch; a
           second trainer runs 2 epochs, a third restores it and runs epoch
           3: parameters, optimizer state and history bit-identical to the
           uninterrupted run; the `best` checkpoint scores 128 clips through
           make_family_d_score_fn within 1e-5 of the eval step
  family_b_model  a family-B model (random init from seed 0, bank filled
           with 300 rows) scores 128 clips on the card and on the CPU, TF32
           off: scores, reconstructions, features and memory scores within
           1e-4
  family_b_parity  3 float32 family-B train steps at B=16 from the same
           init on the card and on the CPU: losses within rtol 1e-4,
           parameters, BatchNorm statistics and the bank within 5e-5
  family_b_train  (main path 3) `Trainer.fit` with preset("memory_ae"),
           float32, B=256, 1,024 synthetic 8x64x64x1 train clips and 256
           eval clips, uint8 transfer, 3 epochs, eval and checkpoints every
           epoch (the 500-slot bank wraps in epoch 1); 2 epochs + restore +
           epoch 3 bit-identical to the uninterrupted run (parameters,
           BatchNorm statistics, Adam state, bank rows, ptr and fill,
           history); the `best` checkpoint's scorer within 1e-5 of the eval
           step
  family_b_serve  (main path 4) the `best` checkpoint of family_b_train
           served over HTTP by service_from_path(path, family="b"), buckets
           1,8,32,128, warmed up; float32 requests of N=1, 5, 32 and a
           uint8 one of N=8, two of them concurrent; every score within
           1e-5 of the direct scorer; /healthz and /stats answer
  long_model  (main path 5, scoring) the family-D checkpoint scores 128
           64-frame clips with conv_group_impl='s2d' on the card (conv1 on
           K5; the launch counts read over this call alone), against the
           default lowering on the card (K1) and the K5 route's plain
           version on the CPU: within 1e-4
  long_train_parity  3 float32 steps at T=64, B=8 from seed 0 on the card
           and on the CPU, both on the K5 route, on data from the phase's
           own generator: metrics within rtol 1e-4, the parameters after 3
           steps reported; at each step the card's float32 gradient at the
           CPU run's parameters on that step's batch, against the CPU's
           float64 gradient there: every leaf's largest difference, over
           its largest float64 entry (e_card), within 1e-5 + 4 times the
           CPU's own float32 gradient's (e_cpu); each card step and
           gradient launches K5 forward and weight gradient and K2 forward
           and backward once
  long_train  (main path 5) `Trainer.fit` at T=64, B=128, float32, 512
           synthetic train and 128 eval clips, uint8 transfer, 3 epochs,
           conv1 on K5; 2 epochs + restore + epoch 3 bit-identical to the
           uninterrupted run; the `best` checkpoint's scorer within 1e-5 of
           the eval step
  attn_model  family B with the attention encoder at bench.py's flash
           configuration (latent 128, one head, 2 layers; random init from
           seed 0, bank filled with 300 rows of width 128) scores 32 clips
           of 128x64x64x1 on the card (attention on K6) and on the CPU:
           scores and outputs within 1e-4
  attn_parity  3 float32 train steps of that model at B=4, T=128 from seed
           0 on the card and on the CPU: losses within rtol 1e-4;
           parameters, BatchNorm statistics and the bank within 5e-5; each
           card step launches K6 forward and both backward kernels once a
           layer
  widths   configurations whose widths the kernels did not take before,
           one float32 step each from seed 0, card vs CPU at attn_parity's
           tolerances: family D with in_channels=1 at T=8 and T=64 (default
           lowering) and with conv_channels=(32, 32, 64) (conv1 on
           F.conv3d, no K1 launch); family B with the attention encoder at
           latent 256, one head, T=128 (K6 at head dim 256)
  attn_train  (main path 6) `Trainer.fit` with that model, float32, B=16,
           256 synthetic 128-frame train clips and 64 eval clips, uint8
           transfer, 3 epochs, eval and checkpoints every epoch; 2 epochs +
           restore + epoch 3 bit-identical to the uninterrupted run
           (parameters, Adam, BatchNorm statistics, bank rows, ptr, fill,
           history); the `best` checkpoint's scorer within 1e-5 of the eval
           step; K6 forward and backward launched
  times    kernel, plain-version and library times (CUDA events), the
           bounds, per-bucket request latency of both families, bulk
           clips/s, the train step of both families at B=256, the
           long-window step at T=64, B=128 and the attention step at
           B=16, T=128, in f32 and bf16 (median of 20), with device time by
           kernel (torch.profiler); K4 (with its route) and K5 at the
           main shape, K2 and torch.cdist at (256, 256), (64, 16384),
           (33, 9000) and (128, 256) by CUDA events and on the card alone
           (the backward's plan beside), K1 and
           F.conv3d on the same conv at K1_TIMES (B, T) = (1, 8), (8, 8),
           (256, 8), (128, 64) in f32 and bf16, K3 and its library
           expression at MEM_SHAPES, MEM_WIDE and MEM_ATTN with each
           launch's plan, both by CUDA events and on the card alone, the
           two layout copies around K5; K6
           forward, dQ and dK/dV at (B, H, T, Dh) = (16, 1, 128, 128),
           (8, 1, 2048, 128) and (16, 1, 128, 256) against its plain
           version and F.scaled_dot_product_attention (backward alone for
           the gradients, the names of the kernels SDPA ran beside), by
           CUDA events and on the card alone, with bounds at the 3xTF32
           rate in float32 and the CUDA cores' beside them
The kernels phase also holds K4 (forward, input and weight gradient) and
K5 (forward, weight gradient), called through their wrappers and
autograd, against their plain versions at B=2, T=16, 16x16 (RGB with g=4,
grayscale with g=8, 32 output channels with g=4) and at the main shape
B=128, T=64, 64x64, f32 and bf16, a second call bit-identical, each
wrapper counter one higher a call, and each K4 case reports its route
(`k4_route`: bf16 on the tensor cores, f32 on the CUDA cores).  K4 is
also held on a dense N(0, 1) weight at each of those shapes and at one
with N = 20 (bf16 on the CUDA cores), its weight gradient in full, at
those tolerances plus 2^-20 times each output's sum of |terms|; both routes
must be taken.  K5 computes only the band of the
folded kernel: its weight gradient's band entries are held against the
plain version's, its other entries must be exactly 0, and conv1's
(3, 3, 3, C, O) kernel gradient through the fold's autograd against the
plain route's.  K6 (forward, dQ, dK, dV) is held through its autograd
Function against autograd through its plain version at (B, H, T, Dh) in
{(2, 1, 128, 128), (16, 1, 128, 128), (4, 2, 256, 128), (2, 1, 128, 256),
(2, 1, 128, 512)} and at its tile edges {(1, 1, 64, 128), (2, 1, 192,
128), (5, 7, 256, 128), (3, 1, 192, 256), (1, 3, 64, 384), (1, 1, 64,
640)}, causal and not, f32 and bf16 (TF32 off): forward f32 within 1e-5,
gradients within 1e-5 of the largest entry in f32 and 2e-2 of it in bf16
(bf16 forward too), a second call bit-identical, each counter one higher a
call.
Kernel launch counts are set to 0 just before each main path (serve + bulk,
long_score, long_train, train, family_b_train, family_b_serve, attn_train)
and read just after it.  The last lines are the kernels summary, the card's
nvidia-smi name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import io
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "runs" / "dyn_parity_d" / "ours" / "best_improved_model.pth"
BUCKETS = (1, 8, 32, 128)
CLIP = (8, 64, 64, 3)              # (T, H, W, C) of one clip
BULK_CLIPS, BULK_BATCH = 2048, 256
TRAIN_BATCH, TRAIN_CLIPS, EVAL_CLIPS, TRAIN_EPOCHS = 256, 1024, 256, 3
PARITY_BATCH, PARITY_STEPS = 16, 3
PAIR_MASK_RATE = 0.05  # share of rows out of the mask: anomalous pseudo-labels
CLIP_B = (8, 64, 64, 1)            # family B's clip
B_FILL = 300                       # bank rows filled in family_b_model
B_ANOMALY_RATE = 0.2               # the synthetic train split's rate
MEM_SHAPES = ((256, 500, 64), (1024, 4096, 128))  # K3 timing (B, M, D)
# K3 beyond one 1,024-wide chunk of D, and K2 beyond one 8,192-wide chunk
# of N: checked against the plain versions and timed
MEM_WIDE = ((16, 500, 2048), (8, 64, 4096))
# K3 at the attention path's shape (train-b-attn-t128's eval: B=16, a bank
# of 500 x 128), timed beside MEM_SHAPES and MEM_WIDE
MEM_ATTN = (16, 500, 128)
# K3 at its tile edges: B, M and D no multiple of any tile (64 x 64 or
# 16 x 32, D in 32-wide steps), D = 1025 (4-byte pieces), 2048 and 4096,
# each at fills {0, 1, a fill inside a bank tile, M}; with MEM_SHAPES they
# take every (tile, split of D, piece width) the plan can pick.  Checked
# from their own generator (LATER_CHECKS_SEED + 4).
MEM_EDGE = ((33, 70, 100), (65, 65, 65), (17, 97, 1025), (130, 300, 1025),
            (5, 33, 2048), (1, 500, 4096), (200, 700, 37), (600, 1500, 33),
            (3, 7, 8))
# K1 at odd shapes (B, T, H, W): odd H and W, T=1, the long window; f32
# and bf16, from their own generator (LATER_CHECKS_SEED + 5)
K1_EDGE = ((3, 5, 9, 7), (2, 1, 64, 64), (2, 64, 64, 64))
# K1 timed at (B, T): serving buckets, the bulk and train batch, the long
# window on the K1 route
K1_TIMES = ((1, 8), (8, 8), (256, 8), (128, 64))
PAIR_WIDE = (64, 16384)
# K2 at a B that is no multiple of its 16-row tiles, at a wide N
PAIR_ODD = (33, 9000)
# K2's backward plan at its edges (pairwise_backward_plan): row tiles of
# 8, 16, 32 and 64 rows, ragged ones, one split of rows j and many, and N
# no multiple of 4 (4-byte staging); checked from their own generator
# (LATER_CHECKS_SEED + 7)
PAIR_PLAN_EDGES = ((8, 256), (16, 256), (17, 256), (31, 256), (32, 256),
                   (128, 256), (257, 256), (37, 1001))
# K2 timed at the long-window path's batch (train-d-t64, B=128), from its
# own generator (LATER_CHECKS_SEED + 8)
PAIR_T64 = (128, 256)
# conv1 widths K1 does not take (TFoldConv1 runs F.conv3d there), (C, O)
CONV1_WIDTHS = ((1, 16), (3, 32))
# family B with the attention encoder at head dim 256 (K6 over two chunks)
WIDE_HEAD = dict(temporal_encoder="attention", latent_dim=256, attn_heads=1)
# long windows (main path 5): (T, H, W, C) of one clip, batch, T-group size
LONG_CLIP, LONG_BATCH, LONG_G = (64, 64, 64, 3), 128, 8
LONG_TRAIN_CLIPS, LONG_EVAL_CLIPS, LONG_PARITY_BATCH = 512, 128, 8
# long_train_parity: the seed of its own generator (its clips and
# pseudo-labels), and its gradient bound, e_card <= GRAD_ABS + GRAD_KAPPA *
# e_cpu for every leaf at every step (phase_long_train_parity)
LONG_PARITY_SEED = 11
GRAD_ABS, GRAD_KAPPA = 1e-5, 4.0
# K4/K5 checks: (B, T, H, W, g, C, O): the small case of
# tests/test_s2d_fold.py, grayscale and 32 output channels at its size, and
# the main path's shape
S2D_CASES = ((2, 16, 16, 16, 4, 3, 16), (2, 16, 16, 16, 8, 1, 16),
             (2, 16, 16, 16, 4, 3, 32), (LONG_BATCH, 64, 64, 64, LONG_G, 3, 16))
# K4 on dense weights: N of an extra case beside S2D_CASES' shapes, no
# multiple of 8, so that bf16 takes the CUDA cores (k4_route)
K4_ODD_N = 20
# the checks of K4 on dense weights and of K2 at PAIR_ODD draw from their
# own generator, so that adding them left every other phase's data as it
# was
LATER_CHECKS_SEED = 8
# family B with the attention encoder (main path 6): bench.py's flash
# configuration (measure_flash_attention), (T, H, W, C) of one clip
ATTN_MODEL = dict(temporal_encoder="attention", latent_dim=128, attn_heads=1)
ATTN_CLIP, ATTN_BATCH, ATTN_PARAMS = (128, 64, 64, 1), 16, 2302273
ATTN_TRAIN_CLIPS, ATTN_EVAL_CLIPS, ATTN_SCORE_CLIPS = 256, 64, 32
ATTN_PARITY_BATCH = 4
# K6 checks and times, (B, H, T, Dh): the main path's shape is the second
FLASH_CASES = ((2, 1, 128, 128), (16, 1, 128, 128), (4, 2, 256, 128),
               (2, 1, 128, 256), (2, 1, 128, 512))
FLASH_TIMES = ((16, 1, 128, 128), (8, 1, 2048, 128), (16, 1, 128, 256))
# K6 at its tile edges (T = 64, T = 192, B*H = 35 on 64-row blocks, head
# dims 384 and 640, the latter streamed), checked from their own generator
# (LATER_CHECKS_SEED + 3)
FLASH_EDGE_CASES = ((1, 1, 64, 128), (2, 1, 192, 128), (5, 7, 256, 128),
                    (3, 1, 192, 256), (1, 3, 64, 384), (1, 1, 64, 640))
# the port's CUDA kernels by symbol name (cvad_tpu_torch/csrc/*.cu), picked
# out of the profiler's rows
PORT_KERNELS = ("tfold_conv1_", "pairwise_", "memory_min_cosine_",
                "s2d_conv_", "s2d_wgrad_", "s2d_group_",
                "flash_fwd_kernel",
                "flash_bwd_")
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32 products as 3xTF32 on the tensor cores: three TF32 products each
TF32X3_FLOPS = 494.7e12 / 3


_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line carries the seconds since the script
    started (`elapsed_s`)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def no_tf32():
    """float32 convolutions in full float32 (cuDNN uses TF32 by default)."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean milliseconds per call of `fn` from CUDA events over `iters`
    warm calls."""
    for _ in range(warm):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the card alone: CUDA events
    around `iters` calls queued behind a spin kernel (`torch.cuda._sleep`),
    so that they time the card running the calls back to back and not the
    host issuing them.  The spin is lengthened until the host has queued
    every call before it ends (the start event still pending)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's clocks
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


def post(url: str, body: bytes, ctype: str) -> dict:
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        check(r.status == 200, f"POST {url} answered {r.status}")
        return json.loads(r.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        check(r.status == 200, f"GET {url} answered {r.status}")
        return json.loads(r.read())


def npz(clips: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, clips=clips)
    return buf.getvalue()


def phase_device() -> dict:
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return {"name": name, "count": count, "card": smi}


def phase_build() -> None:
    from cvad_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(_build.sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln]
                    for name, log in logs.items()}})


def phase_kernels(rng: np.random.Generator) -> dict:
    from cvad_tpu_torch.ops.pallas_conv import (tfold_conv1,
                                                tfold_conv1_reference)

    w = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                         .astype(np.float32)).cuda()
    cases, err32, err16 = [], 0.0, 0.0
    for b in (1, 3, 128, 256):
        x = torch.from_numpy(rng.uniform(0, 1, (b, 3) + CLIP[:3])
                             .astype(np.float32)).cuda()
        with no_tf32():
            ref = tfold_conv1_reference(x, w)
        got = tfold_conv1(x, w)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (b, 16, 8, 32, 32),
              f"tfold_conv1 shape {tuple(got.shape)}")
        e32 = (got - ref).abs().max().item()
        xb, wb = x.bfloat16(), w.bfloat16()
        with no_tf32():
            ref16 = tfold_conv1_reference(xb.float(), wb.float())
        got16 = tfold_conv1(xb, wb)
        torch.cuda.synchronize()
        check(got16.dtype == torch.bfloat16, "bf16 output dtype")
        d16 = (got16.float() - ref16).abs()
        within = bool((d16 <= 1e-2 * ref16.abs() + 1e-5).all())
        e16 = d16.max().item()
        cases.append({"B": b, "f32_max_abs_err": e32,
                      "bf16_max_abs_err": e16, "bf16_within_rtol": within})
        check(e32 <= 1e-4, f"tfold_conv1 f32 B={b} max err {e32}")
        check(within, f"tfold_conv1 bf16 B={b} beyond rtol 1e-2 "
                      f"(max abs err {e16})")
        err32, err16 = max(err32, e32), max(err16, e16)
    edge = check_tfold_edges(np.random.default_rng(LATER_CHECKS_SEED + 5))
    err32 = max(err32, max(c["f32_max_abs_err"] for c in edge))
    err16 = max(err16, max(c["bf16_max_abs_err"] for c in edge))
    grad = check_tfold_grad(rng)
    widths = check_conv1_widths(rng)
    pair = check_pairwise(rng)
    mem = check_memory(rng)
    s2d = check_s2d(rng)
    flash = check_flash(rng)
    emit({"phase": "kernels", "s2d": s2d, "flash": flash, "kernels": [
        {"name": "tfold_conv1", "comparison_launches": tfold_conv1.launches,
         "max_abs_err_f32": err32, "max_abs_err_bf16": err16,
         "cases": cases, "edges": edge, "grad": grad,
         "other_widths": widths},
        {"name": "pairwise_l1", **pair},
        {"name": "memory_min_cosine", **mem}]})
    return {"f32": err32, "bf16": err16, "pair_fwd": pair["max_abs_err_avg"],
            "pair_bwd": pair["max_abs_err_grad"],
            "memory": mem["max_abs_err"], "s2d": s2d["max_abs_err"],
            "flash": flash["max_abs_err"]}


def flash_inputs(rng: np.random.Generator, shape: tuple,
                 dtype: torch.dtype = torch.float32) -> tuple:
    """q, k, v and a cotangent (B, H, T, Dh), standard normal, on the card
    in `dtype`."""
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .cuda().to(dtype) for _ in range(4))


def flash_grads(q, k, v, ct, causal: bool, fn=None) -> dict:
    """The output of `fn` (K6's autograd Function by default) and its
    gradients w.r.t. q, k and v for the cotangent `ct`."""
    from cvad_tpu_torch.ops.flash_attention import flash_attention

    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = (fn or flash_attention)(*xs, causal=causal,
                                  sm_scale=q.shape[3] ** -0.5)
    grads = torch.autograd.grad(out, xs, ct)
    return dict(zip(("forward", "dq", "dk", "dv"), (out.detach(), *grads)))


def check_flash(rng: np.random.Generator) -> dict:
    """K6 forward, dQ and dK/dV through its autograd Function against
    autograd through `attention_reference` in float32 on the same (rounded)
    inputs, TF32 off, at FLASH_CASES and FLASH_EDGE_CASES, causal and
    not, f32 and bf16; a second call bit-identical and each counter one
    higher a call.  f32:
    forward within 1e-5, gradients within 1e-5 of the largest |ref| entry
    (float32 sums over T in another order); bf16: within 2e-2 of the
    largest entry (P and dS rounded to bf16 before their products, as the
    library does, and the outputs cast once)."""
    from cvad_tpu_torch.ops.flash_attention import (attention_reference,
                                                    flash_attention)

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain version would not be float32")
    errs, cases = {}, []
    later = np.random.default_rng(LATER_CHECKS_SEED + 3)
    for shape, gen in [(c, rng) for c in FLASH_CASES] + [
            (c, later) for c in FLASH_EDGE_CASES]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ct = flash_inputs(gen, shape, dtype)
            for causal in (False, True):
                before = counts()
                got = flash_grads(q, k, v, ct, causal)
                again = flash_grads(q, k, v, ct, causal)
                rose = {n: counts()[n] - before[n] for n in
                        ("flash_forward", "flash_dq", "flash_dkv")}
                ref = flash_grads(q.float(), k.float(), v.float(),
                                  ct.float(), causal, attention_reference)
                torch.cuda.synchronize()
                case = {"shape": list(shape), "causal": causal,
                        "dtype": str(dtype).replace("torch.", "")}
                check(all(n == 2 for n in rose.values()),
                      f"K6 counters rose by {rose} over two calls at {case}")
                for name, r in ref.items():
                    y = got[name]
                    where = f"{name} at {case}"
                    check(y.dtype == dtype and y.shape == r.shape,
                          f"dtype or shape of {where}")
                    check(torch.equal(y, again[name]),
                          f"{where}: a second call is not bit-identical")
                    err = (y.float() - r).abs().max().item()
                    scale = r.abs().max().item()
                    if dtype == torch.bfloat16:
                        tol = 2e-2 * scale
                    else:
                        tol = 1e-5 if name == "forward" else 1e-5 * scale
                    case[name] = err
                    check(err <= tol,
                          f"{where}: max abs err {err} beyond {tol}")
                    key = f"{name}_{case['dtype']}"
                    errs[key] = max(errs.get(key, 0.0), err)
                cases.append(case)
    return {"cases": cases, "max_abs_err": errs,
            "bit_identical_second_call": True}


def s2d_inputs(rng: np.random.Generator, b: int, t: int, h: int, w: int,
               g: int, dtype: torch.dtype = torch.float32, cin: int = 3,
               cout: int = 16) -> dict:
    """K4's and K5's operands on the card, from clips (B, T, H, W, C) in
    [0, 1) and a (3, 3, 3, C, O) kernel ~ N(0, 0.2^2), with N(0, 1)
    cotangents, in `dtype`."""
    from cvad_tpu_torch.ops import pallas_s2d as ps

    x = torch.from_numpy(rng.uniform(0, 1, (b, t, h, w, cin))
                         .astype(np.float32)).cuda().to(dtype)
    k = torch.from_numpy(rng.normal(0, 0.2, (3, 3, 3, cin, cout))
                         .astype(np.float32)).cuda().to(dtype)
    xf = ps.s2d_fold_input(x, g).contiguous()
    wd = ps.s2d_fold_kernel(k, g).contiguous()
    xg = ps.s2d_fold_groups(x, g).contiguous()
    wdp = ps._pad_wd(wd).contiguous()
    gen = torch.Generator("cuda").manual_seed(int(rng.integers(1 << 30)))
    ho, wo = h // 2, w // 2
    return {"xf": xf, "k": k, "wd": wd, "w4": wd.reshape(4, *wd.shape[2:]),
            "xg": xg, "wdp": wdp, "n": t // g, "g": g, "cin": cin,
            "cout": cout,
            "ct4": torch.randn((xf.shape[0], ho, wo, wd.shape[3]),
                               generator=gen, device="cuda").to(dtype),
            "ct5": torch.randn((b, ho, wo, t * cout), generator=gen,
                               device="cuda").to(dtype)}


def k4_wrapper_grads(xf: torch.Tensor, wd: torch.Tensor,
                     ct: torch.Tensor) -> dict:
    """K4 through `s2d_fold_matmul` and autograd (x and the weight), each
    wrapper counter one higher a call."""
    from cvad_tpu_torch.ops import pallas_s2d as ps

    k4 = ps.s2d_fold_matmul
    names = ("launches", "dgrad_launches", "wgrad_launches")
    before = [getattr(k4, a) for a in names]
    xr, wr = xf.detach().requires_grad_(True), wd.detach().requires_grad_(True)
    y = k4(xr, wr)
    dx, dw = torch.autograd.grad(y, (xr, wr), ct)
    rose = [getattr(k4, a) - b for a, b in zip(names, before)]
    check(rose == [1, 1, 1], f"K4 wrapper counters rose by {rose}")
    return {"k4_forward": y.detach(), "k4_dgrad": dx, "k4_wgrad": dw}


def s2d_wrapper_grads(d: dict, g: int) -> dict:
    """K4 and K5 through their wrappers, as a model calls them: the outputs
    of `s2d_fold_matmul(xf, wd)` and `s2d_group_conv(xg, s2d_fold_kernel(k,
    g), g)`, and their gradients from `torch.autograd.grad` with the
    cotangents of `d` (K4: x and the weight; K5: the folded weight and
    conv1's (3, 3, 3, C, O) kernel through `s2d_fold_kernel`'s autograd, as
    in a train step, where conv1's input needs none).  Checks that each
    wrapper counter rose by one."""
    from cvad_tpu_torch.ops import pallas_s2d as ps

    out = k4_wrapper_grads(d["xf"], d["wd"], d["ct4"])
    k5 = ps.s2d_group_conv
    before = (k5.launches, k5.backward_launches)
    kk = d["k"].detach().requires_grad_(True)
    wd5 = ps.s2d_fold_kernel(kk, g)
    y5 = k5(d["xg"], wd5, g)
    dw5, dk5 = torch.autograd.grad(y5, (wd5, kk), d["ct5"])
    rose = (k5.launches - before[0], k5.backward_launches - before[1])
    check(rose == (1, 1), f"K5 wrapper counters rose by {rose}, not 1 each")
    return out | {"k5_forward": y5.detach(), "k5_wgrad": dw5,
                  "k5_conv1_wgrad": dk5}


def s2d_plain_conv1_wgrad(d: dict, ref_dw: torch.Tensor) -> tuple:
    """conv1's kernel gradient by the plain route in `d`'s dtype (the fold,
    `_xla_slabs_core`, autograd), and the sum over the fold's summands of
    |ref_dw| (the float32 plain folded gradient, (2, 2, kc, N)): the bound
    of one rounding of each summand."""
    from cvad_tpu_torch.ops import pallas_s2d as ps

    g = d["g"]
    kk = d["k"].detach().requires_grad_(True)
    y = ps._xla_slabs_core(d["xg"], ps._pad_wd(ps.s2d_fold_kernel(kk, g)),
                           d["n"])
    (dk,) = torch.autograd.grad(y, kk, d["ct5"])
    kz = torch.zeros_like(d["k"], dtype=torch.float32, requires_grad=True)
    (mag,) = torch.autograd.grad(ps.s2d_fold_kernel(kz, g), kz, ref_dw.abs())
    return dk, mag


def check_s2d(rng: np.random.Generator) -> dict:
    """K4 forward, dgrad and wgrad and K5 forward and wgrad, through their
    wrappers and autograd (`s2d_wrapper_grads`), against their plain
    versions at S2D_CASES, float32 and bfloat16 (against the plain version
    in float32 on the same bf16-rounded inputs), and a second call
    bit-identical.  Outputs (forward, dgrad): float32 within atol 1e-4
    (f32 sums of up to 4 x 128 terms in another order), bf16 within
    1e-2 |ref| + 1e-4 (one bf16 rounding of the f32 sum); weight gradients
    (float32 sums over every pixel, in another order, then cast to the
    weight's dtype): within 1e-5 of the largest |ref| entry, plus 2^-8 |ref|
    in bf16 (the one rounding of the cast).  K5 computes only the band of
    the folded kernel (`s2d_band_mask`), so its weight gradient is held
    three ways: the band entries as above; the others exactly 0; and
    conv1's (3, 3, 3, C, O) kernel gradient through `s2d_fold_kernel`'s
    autograd against the plain route's in the same dtype, within 1e-5 of
    its largest |ref| entry, plus in bf16 2^-8 times the sum of the |terms|
    the fold's backward adds (each rounded once to bf16) and one bf16 ulp of
    the result (2^-7 |ref|: both routes round their sum to bf16 once)."""
    from cvad_tpu_torch.ops import pallas_s2d as ps

    errs, cases = {}, []
    for b, t, h, w, g, cin, cout in S2D_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            d = s2d_inputs(rng, b, t, h, w, g, dtype, cin, cout)
            kc, kp, n = d["wd"].shape[2], d["wdp"].shape[1], d["n"]
            got, again = s2d_wrapper_grads(d, g), s2d_wrapper_grads(d, g)
            f = {k: v.float() for k, v in d.items() if torch.is_tensor(v)}
            ref = {"k4_forward": ps._xla_dot_core(f["xf"], f["wd"]),
                   "k4_dgrad": ps.s2d_matmul_dgrad_reference(f["ct4"],
                                                             f["wd"]),
                   "k4_wgrad": ps.s2d_matmul_wgrad_reference(f["xf"],
                                                             f["ct4"]),
                   "k5_forward": ps._xla_slabs_core(f["xg"], f["wdp"], n),
                   # the pad rows of _pad_wd carry no gradient to wd
                   "k5_wgrad": ps.s2d_group_wgrad_reference(
                       f["xg"], f["ct5"], kp)[:, :kc].reshape(d["wd"].shape)}
            ref_dk, mag = s2d_plain_conv1_wgrad(d, ref["k5_wgrad"])
            band = ps.s2d_band_mask(g, cin, cout, kp)[:kc].cuda().expand(
                d["wd"].shape)
            torch.cuda.synchronize()
            case = {"B": b, "T": t, "H": h, "W": w, "g": g, "C": cin,
                    "O": cout, "dtype": str(dtype).replace("torch.", ""),
                    "k4_route": ps.k4_route(kc, d["wd"].shape[3],
                                            d["xf"].shape[2], dtype)}
            for name, r in ref.items():
                y = got[name]
                where = f"{name} at {case}"
                check(tuple(y.shape) == tuple(r.shape), f"shape of {where}")
                check(y.dtype == dtype, f"dtype of {where}")
                check(torch.equal(y, again[name]),
                      f"{where}: a second call is not bit-identical")
                if name == "k5_wgrad":  # the band entries, then the rest
                    off = y[~band]
                    check(not off.any(), f"{where}: {int((off != 0).sum())}"
                                         f" entries off the band are not 0")
                    y, r = y[band], r[band]
                e = (y.float() - r).abs()
                if name.endswith("wgrad"):
                    tol = 1e-5 * r.abs().max().item()
                    if dtype == torch.bfloat16:
                        tol = tol + 2.0 ** -8 * r.abs()
                    ok = bool((e <= tol).all())
                elif dtype == torch.float32:
                    ok = bool((e <= 1e-4).all())
                else:
                    ok = bool((e <= 1e-2 * r.abs() + 1e-4).all())
                err = e.max().item()
                case[name] = err
                check(ok, f"{where}: max abs err {err} beyond tolerance")
                key = f"{name}_{case['dtype']}"
                errs[key] = max(errs.get(key, 0.0), err)
            dk = got["k5_conv1_wgrad"]
            check(dk.dtype == dtype and torch.equal(dk,
                                                    again["k5_conv1_wgrad"]),
                  f"conv1 kernel gradient dtype or second call at {case}")
            e = (dk.float() - ref_dk.float()).abs()
            tol = 1e-5 * ref_dk.float().abs().max().item()
            if dtype == torch.bfloat16:
                tol = tol + 2.0 ** -8 * mag
            err = e.max().item()
            case["k5_conv1_wgrad"] = err
            worst = int((e - tol).argmax()) if torch.is_tensor(tol) else 0
            if dtype == torch.bfloat16:  # the entry nearest its bound
                case["k5_conv1_wgrad_worst"] = {
                    "got": dk.flatten()[worst].item(),
                    "plain": ref_dk.flatten()[worst].item(),
                    "sum_abs_terms": mag.flatten()[worst].item()}
            check(bool((e <= tol).all()),
                  f"k5_conv1_wgrad at {case}: max abs err {err} beyond "
                  f"tolerance (worst entry: got "
                  f"{dk.flatten()[worst].item()}, plain "
                  f"{ref_dk.flatten()[worst].item()}, sum of |terms| "
                  f"{mag.flatten()[worst].item()})")
            key = f"k5_conv1_wgrad_{case['dtype']}"
            errs[key] = max(errs.get(key, 0.0), err)
            cases.append(case)
            del d, got, again, f, ref
    dense = check_k4_dense(np.random.default_rng(LATER_CHECKS_SEED + 1), errs)
    routes = {c["k4_route"] for c in cases + dense}
    check(routes == {"tensor_cores", "cuda_cores"},
          f"K4's checks took the routes {routes}, not both")
    return {"cases": cases, "k4_dense_cases": dense, "max_abs_err": errs,
            "off_band_entries_zero": True,
            "bit_identical_second_call": True}


def check_k4_dense(rng: np.random.Generator, errs: dict) -> list:
    """K4 (forward, input and weight gradient) through its wrapper and
    autograd on a dense random wd, N(0, 1) in every entry (not
    `s2d_fold_kernel`'s banded output: a K4 that skipped the band's zeros
    would pass the folded cases), at each S2D_CASES shape and at one with
    N = K4_ODD_N, float32 and bfloat16, each case on the route `k4_route`
    gives; a second call bit-identical; the weight gradient compared in
    full.  Tolerances are check_s2d's, whose absolute 1e-4 for outputs
    stood for float32 sums of terms near 1 in another order: at N(0, 1)
    weights the outputs reach ~100, where float32 rounding alone passes
    1e-4 for some of the 1.3e8 outputs of the main shape in any summation
    order, so outputs also get 2^-20 times their sum of |terms| (the plain
    version on |operands|), as K5's conv1 check gets 2^-8 of it in bf16."""
    from cvad_tpu_torch.ops import pallas_s2d as ps

    shapes = list(S2D_CASES) + [S2D_CASES[0][:6] + (None,)]  # N = K4_ODD_N
    cases = []
    for b, t, h, w, g, cin, cout in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            d = s2d_inputs(rng, b, t, h, w, g, dtype, cin, cout or 16)
            xf, kc = d["xf"], d["wd"].shape[2]
            n = g * cout if cout else K4_ODD_N
            gen = torch.Generator("cuda").manual_seed(
                int(rng.integers(1 << 30)))
            wd = torch.randn((2, 2, kc, n), generator=gen,
                             device="cuda").to(dtype)
            ct = torch.randn((xf.shape[0], xf.shape[1] - 1, xf.shape[2] - 1,
                              n), generator=gen, device="cuda").to(dtype)
            del d
            got, again = (k4_wrapper_grads(xf, wd, ct),
                          k4_wrapper_grads(xf, wd, ct))
            x32, w32, c32 = xf.float(), wd.float(), ct.float()
            ref = {"k4_forward": ps._xla_dot_core(x32, w32),
                   "k4_dgrad": ps.s2d_matmul_dgrad_reference(c32, w32),
                   "k4_wgrad": ps.s2d_matmul_wgrad_reference(x32, c32)}
            terms = {"k4_forward": ps._xla_dot_core(x32.abs(), w32.abs()),
                     "k4_dgrad": ps.s2d_matmul_dgrad_reference(c32.abs(),
                                                               w32.abs())}
            torch.cuda.synchronize()
            case = {"rows": xf.shape[0], "Hc": xf.shape[1],
                    "Wc": xf.shape[2], "K": kc, "N": n,
                    "dtype": str(dtype).replace("torch.", ""),
                    "k4_route": ps.k4_route(kc, n, xf.shape[2], dtype)}
            for name, r in ref.items():
                y = got[name]
                where = f"{name} on dense weights at {case}"
                check(tuple(y.shape) == tuple(r.shape), f"shape of {where}")
                check(y.dtype == dtype, f"dtype of {where}")
                check(torch.equal(y, again[name]),
                      f"{where}: a second call is not bit-identical")
                e = (y.float() - r).abs()
                if name == "k4_wgrad":
                    tol = 1e-5 * r.abs().max().item()
                    if dtype == torch.bfloat16:
                        tol = tol + 2.0 ** -8 * r.abs()
                elif dtype == torch.float32:
                    tol = 1e-4 + 2.0 ** -20 * terms[name]
                else:
                    tol = 1e-2 * r.abs() + 1e-4 + 2.0 ** -20 * terms[name]
                err = e.max().item()
                case[name] = err
                check(bool((e <= tol).all()),
                      f"{where}: max abs err {err} beyond tolerance")
                key = f"{name}_dense_{case['dtype']}"
                errs[key] = max(errs.get(key, 0.0), err)
            cases.append(case)
            del xf, wd, ct, got, again, ref, terms, x32, w32, c32
            torch.cuda.empty_cache()
    return cases


def memory_inputs(rng: np.random.Generator, b: int, m: int, d: int):
    """query (B, D) and memory (M, D), standard normal, on the card."""
    return (torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
            .cuda(),
            torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
            .cuda())


def check_memory(rng: np.random.Generator) -> dict:
    """K3 against its plain version at every fill of {0, 1, M/2, M}, a
    second call bit-identical to the first, and a NaN query row giving NaN
    (and no other row)."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        memory_min_cosine_distance, memory_min_cosine_distance_reference)

    err, n_cases = 0.0, 0
    for b in (1, 7, 128, 256, 1024):
        for m in (1, 10, 500, 4096):
            for d in (64, 128):
                q, mem = memory_inputs(rng, b, m, d)
                for fill in sorted({0, 1, m // 2, m}):
                    f = torch.tensor(fill, dtype=torch.int32, device="cuda")
                    got = memory_min_cosine_distance(q, mem, f)
                    again = memory_min_cosine_distance(q, mem, f)
                    ref = memory_min_cosine_distance_reference(q, mem, f)
                    torch.cuda.synchronize()
                    case = f"B={b} M={m} D={d} fill={fill}"
                    check(got.shape == (b,) and got.dtype == torch.float32
                          and bool(torch.isfinite(got).all()),
                          f"memory_min_cosine output at {case}")
                    e = (got - ref).abs().max().item()
                    check(e <= 1e-6, f"memory_min_cosine err {e} at {case}")
                    check(torch.equal(got, again),
                          f"memory_min_cosine not bit-identical at {case}")
                    err = max(err, e)
                    n_cases += 1
    wide = []
    for b, m, d in MEM_WIDE:  # more than one 1,024-wide chunk of D
        q, mem = memory_inputs(rng, b, m, d)
        f = torch.tensor(m, dtype=torch.int32, device="cuda")
        got = memory_min_cosine_distance(q, mem, f)
        again = memory_min_cosine_distance(q, mem, f)
        ref = memory_min_cosine_distance_reference(q, mem, f)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        check(e <= 1e-6, f"memory_min_cosine err {e} at B={b} M={m} D={d}")
        check(torch.equal(got, again),
              f"memory_min_cosine not bit-identical at D={d}")
        wide.append({"B": b, "M": m, "D": d, "max_abs_err": e})
        err = max(err, e)
        n_cases += 1
    edges = check_memory_edges(np.random.default_rng(LATER_CHECKS_SEED + 4))
    err = max(err, edges["max_abs_err"])
    n_cases += edges["cases"]
    q, mem = memory_inputs(rng, 9, 500, 64)
    q[4, 7] = float("nan")
    got = memory_min_cosine_distance(q, mem, 500)
    ref = memory_min_cosine_distance_reference(
        q, mem, torch.tensor(500, device="cuda"))
    torch.cuda.synchronize()
    rest = [i for i in range(9) if i != 4]
    check(bool(torch.isnan(got[4])) and bool(torch.isnan(ref[4]))
          and bool(torch.isfinite(got[rest]).all()),
          f"memory_min_cosine NaN row: {got.tolist()}")
    return {"cases": n_cases, "max_abs_err": err, "nan_row_gives_nan": True,
            "wide": wide, "edges": edges,
            "comparison_launches": memory_min_cosine_distance.launches}


def check_memory_edges(rng: np.random.Generator) -> dict:
    """K3 at MEM_EDGE, each at fills {0, 1, a fill inside a bank tile, M}:
    within 1e-6 of the plain version, a second call bit-identical, and a
    NaN query row giving NaN in that row alone; every plan kind (tile,
    split of D or not, 16- or 4-byte pieces) that MEM_SHAPES, MEM_WIDE,
    MEM_ATTN and these shapes give must have been taken."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        memory_min_cosine_distance, memory_min_cosine_distance_reference,
        memory_plan)
    from cvad_tpu_torch.runtime.device import sm_count

    sms = sm_count(torch.device("cuda", 0))
    err, cases, kinds = 0.0, 0, set()
    for b, m, d in MEM_EDGE + MEM_SHAPES + MEM_WIDE + (MEM_ATTN,):
        plan = memory_plan(b, m, d, sms)
        kinds.add((plan.tile, plan.splits > 1, d % 4 == 0))
        if (b, m, d) not in MEM_EDGE:
            continue  # checked at every fill in check_memory
        q, mem = memory_inputs(rng, b, m, d)
        q[b // 2, d // 3] = float("nan")
        rest = [i for i in range(b) if i != b // 2]
        for fill in sorted({0, 1, min(m, 37), m}):
            f = torch.tensor(fill, dtype=torch.int32, device="cuda")
            got = memory_min_cosine_distance(q, mem, f)
            again = memory_min_cosine_distance(q, mem, f)
            ref = memory_min_cosine_distance_reference(q, mem, f)
            torch.cuda.synchronize()
            case = f"B={b} M={m} D={d} fill={fill} plan={tuple(plan)}"
            check(torch.equal(got.view(torch.int32),
                              again.view(torch.int32)),
                  f"memory_min_cosine not bit-identical at {case}")
            check(fill == 0 or (bool(torch.isnan(got[b // 2]))
                                and bool(torch.isfinite(got[rest]).all())),
                  f"memory_min_cosine NaN row at {case}")
            e = (got[rest] - ref[rest]).abs().max().item() if rest else 0.0
            check(e <= 1e-6, f"memory_min_cosine err {e} at {case}")
            err = max(err, e)
            cases += 1
    want = {(0, False, True), (0, False, False), (1, False, True),
            (1, False, False), (1, True, True), (1, True, False)}
    check(want <= kinds, f"K3 plan kinds taken: {sorted(kinds)}")
    return {"cases": cases, "max_abs_err": err,
            "plan_kinds": sorted(kinds)}


def check_tfold_edges(rng: np.random.Generator) -> list:
    """K1 at K1_EDGE (odd H and W, T=1, T=64) against its plain version on
    the same inputs, f32 within atol 1e-4, bf16 within 1e-2 |ref| + 1e-5
    of the plain version in float32 on the bf16-rounded inputs; a second
    call bit-identical, each with the unit height (`k1_rows`) it took."""
    from cvad_tpu_torch.ops.pallas_conv import (k1_rows, tfold_conv1,
                                                tfold_conv1_reference)
    from cvad_tpu_torch.runtime.device import sm_count

    w = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                         .astype(np.float32)).cuda()
    out = []
    for b, t, h, wd in K1_EDGE:
        x = torch.from_numpy(rng.uniform(0, 1, (b, 3, t, h, wd))
                             .astype(np.float32)).cuda()
        case = {"B": b, "T": t, "H": h, "W": wd,
                "rows": k1_rows(b, t, h, wd, sm_count(x.device))}
        for dtype in (torch.float32, torch.bfloat16):
            xd, wdt = x.to(dtype), w.to(dtype)
            with no_tf32():
                ref = tfold_conv1_reference(xd.float(), wdt.float())
            got = tfold_conv1(xd, wdt)
            again = tfold_conv1(xd, wdt)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            check(got.shape == ref.shape and got.dtype == dtype,
                  f"tfold_conv1 {name} shape at {case}")
            check(torch.equal(got, again),
                  f"tfold_conv1 {name} not bit-identical at {case}")
            d = (got.float() - ref).abs()
            if dtype == torch.float32:
                e = d.max().item()
                check(e <= 1e-4, f"tfold_conv1 f32 err {e} at {case}")
                case["f32_max_abs_err"] = e
            else:
                check(bool((d <= 1e-2 * ref.abs() + 1e-5).all()),
                      f"tfold_conv1 bf16 beyond rtol 1e-2 at {case}")
                case["bf16_max_abs_err"] = d.max().item()
        out.append(case)
    return out


def check_tfold_grad(rng: np.random.Generator) -> dict:
    """K1's autograd gradient on the card (the forward launches the kernel,
    the backward runs the plain version) against autograd through
    `tfold_conv1_reference`, for x and the weight."""
    from cvad_tpu_torch.ops.pallas_conv import (tfold_conv1,
                                                tfold_conv1_reference)

    out = {}
    x0 = torch.from_numpy(rng.uniform(0, 1, (4, 3) + CLIP[:3])
                          .astype(np.float32)).cuda()
    w0 = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                          .astype(np.float32)).cuda()
    g0 = torch.from_numpy(rng.normal(0, 1, (4, 16, 8, 32, 32))
                          .astype(np.float32)).cuda()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        grads = []
        for fn in (tfold_conv1, tfold_conv1_reference):
            x = x0.to(dtype).requires_grad_(True)
            w = w0.to(dtype).requires_grad_(True)
            with no_tf32():
                before = tfold_conv1.launches
                grads.append(torch.autograd.grad(fn(x, w), (x, w),
                                                 g0.to(dtype)))
            if fn is tfold_conv1:
                check(tfold_conv1.launches == before + 1,
                      "tfold_conv1 forward with a gradient did not launch")
        torch.cuda.synchronize()
        errs = {}
        for name, got, ref in zip(("x", "weight"), *grads):
            scale = ref.float().abs().max().item()
            errs[name] = (got.float() - ref.float()).abs().max().item()
            check(got.dtype == dtype, f"K1 grad dtype {got.dtype}")
            check(errs[name] <= tol * scale,
                  f"K1 {dtype} grad {name}: max err {errs[name]} beyond "
                  f"{tol} x {scale}")
        out[str(dtype).replace("torch.", "")] = errs
    return out


def check_conv1_widths(rng: np.random.Generator) -> dict:
    """conv1 at the widths K1 does not take (CONV1_WIDTHS, B=2, T=8, 64x64):
    `TFoldConv1` on its 'tfold' route runs F.conv3d there, chosen by shape
    before any launch, so `tfold_conv1.launches` does not rise; the output
    and its weight gradient against the plain folded conv
    (`tfold_conv1_reference`) on the same inputs, TF32 off: f32 within
    atol 1e-4 (outputs) and 1e-5 of the largest |ref| (weight gradient)."""
    from cvad_tpu_torch.models.layers import TFoldConv1
    from cvad_tpu_torch.ops.pallas_conv import (tfold_conv1,
                                                tfold_conv1_reference)

    out = []
    for c, o in CONV1_WIDTHS:
        layer = TFoldConv1(c, o).cuda()
        x = torch.from_numpy(rng.uniform(0, 1, (2, c) + CLIP[:3])
                             .astype(np.float32)).cuda()
        g = torch.from_numpy(rng.normal(size=(2, o, 8, 32, 32))
                             .astype(np.float32)).cuda()
        before = tfold_conv1.launches
        with no_tf32():
            y = layer(x)
            (dw,) = torch.autograd.grad(y, layer.weight, g)
            w = layer.weight.detach().requires_grad_(True)
            ref = tfold_conv1_reference(x, w) + layer.bias.detach().view(
                1, -1, 1, 1, 1)
            (ref_dw,) = torch.autograd.grad(ref, w, g)
        torch.cuda.synchronize()
        e = (y - ref).abs().max().item()
        ew = (dw - ref_dw).abs().max().item()
        case = {"C": c, "O": o, "max_abs_err": e, "wgrad_max_abs_err": ew,
                "k1_launches": tfold_conv1.launches - before}
        check(y.shape == (2, o, 8, 32, 32), f"conv1 shape at {case}")
        check(case["k1_launches"] == 0, f"K1 launched at {case}")
        check(e <= 1e-4 and ew <= 1e-5 * ref_dw.abs().max().item(),
              f"conv1 widths card vs plain at {case}")
        out.append(case)
    return {"cases": out}


def pair_inputs(rng: np.random.Generator, b: int, n: int, mask: str):
    """flat (B, N) in [0, 1) with tied columns (as the adjacency's zero
    diagonal) and a mask of the named kind, on the card."""
    flat = rng.uniform(0, 1, (b, n)).astype(np.float32)
    flat[:, :: max(n // 3, 1)] = 0.0
    m = {"zero": np.zeros(b), "one": np.ones(b),
         "single": np.eye(1, b, b // 2)[0],
         "random": rng.uniform(size=b) >= PAIR_MASK_RATE}[mask]
    return (torch.from_numpy(flat).cuda(),
            torch.from_numpy(m.astype(np.float32)).cuda())


def check_pairwise(rng: np.random.Generator) -> dict:
    """K2 forward and backward against the plain versions, and a second
    call bit-identical to the first; the backward's plan at each shape,
    which must take one split of rows j and many, and both staging
    widths."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        pairwise_backward_plan, pairwise_l1_backward_reference,
        pairwise_l1_mean, pairwise_l1_reference)
    from cvad_tpu_torch.runtime.device import sm_count

    err_avg = err_grad = 0.0
    n_cases = 0
    plans = {}
    shapes = [(b, n) for b in (1, 2, 33, 256) for n in (1, 7, 256)]
    shapes.append(PAIR_WIDE)  # many 512-wide chunks of N
    shapes.append(PAIR_ODD)  # and ragged 16-row tiles, from its own stream
    shapes.extend(PAIR_PLAN_EDGES)  # from their own stream too
    streams = {PAIR_ODD: np.random.default_rng(LATER_CHECKS_SEED)}
    edges = np.random.default_rng(LATER_CHECKS_SEED + 7)
    streams.update(dict.fromkeys(PAIR_PLAN_EDGES, edges))
    for b, n in shapes:
        plans[f"{b}x{n}"] = pairwise_backward_plan(
            b, n, sm_count(torch.device("cuda")))._asdict()
        for mask in ("zero", "single", "random", "one"):
            flat, m = pair_inputs(streams.get((b, n), rng), b, n, mask)
            f = flat.clone().requires_grad_(True)
            avg, n_pairs = pairwise_l1_mean(f, m)
            (g,) = torch.autograd.grad(avg, f)
            avg2, _ = pairwise_l1_mean(f, m)
            (g2,) = torch.autograd.grad(avg2, f)
            ref, ref_n = pairwise_l1_reference(flat, m)
            ref_g = pairwise_l1_backward_reference(
                flat, m, ref_n, torch.ones((), device="cuda"))
            torch.cuda.synchronize()
            case = f"B={b} N={n} mask={mask}"
            ea = abs(avg.item() - ref.item())
            eg = (g - ref_g).abs().max().item()
            check(n_pairs.item() == ref_n.item(),
                  f"pairwise n_pairs {n_pairs.item()} vs "
                  f"{ref_n.item()} at {case}")
            check(ea <= 1e-5 * abs(ref.item()) + 1e-7,
                  f"pairwise avg err {ea} at {case}")
            check(eg <= 1e-6, f"pairwise grad err {eg} at {case}")
            check(torch.equal(avg, avg2) and torch.equal(g, g2),
                  f"pairwise not bit-identical across calls at {case}")
            err_avg, err_grad = max(err_avg, ea), max(err_grad, eg)
            n_cases += 1
    splits = {p["splits"] > 1 for p in plans.values()}
    check(splits == {False, True}, f"pairwise backward plans took splits "
                                   f"{splits}, not one and many")
    check({int(k.split("x")[1]) % 4 == 0 for k in plans} == {False, True},
          "pairwise backward: both staging widths")
    return {"cases": n_cases, "max_abs_err_avg": err_avg,
            "max_abs_err_grad": err_grad, "backward_plans": plans,
            "comparison_launches": pairwise_l1_mean.launches,
            "comparison_backward_launches":
                pairwise_l1_mean.backward_launches}


def phase_model(state: dict, clips: np.ndarray) -> None:
    from cvad_tpu_torch.evaluation.scoring import make_family_d_score_fn
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1

    before = tfold_conv1.launches
    s_gpu, a_gpu = make_family_d_score_fn(state)(clips)
    rose = tfold_conv1.launches - before
    s_cpu, a_cpu = make_family_d_score_fn(state, device="cpu")(clips)
    es, ea = (float(np.abs(s_gpu - s_cpu).max()),
              float(np.abs(a_gpu - a_cpu).max()))
    emit({"phase": "model", "clips": len(clips), "k1_launches": rose,
          "score_max_abs_err": es, "adj_max_abs_err": ea,
          "score_mean": float(s_gpu.mean()),
          "edges_per_graph": float((a_gpu > 0.1).sum((1, 2)).mean())})
    check(s_gpu.shape == (len(clips),) and a_gpu.shape == (len(clips), 16, 16),
          "model output shapes")
    check(bool(np.isfinite(s_gpu).all() and np.isfinite(a_gpu).all()),
          "model outputs finite")
    check(rose > 0, "the model forward did not launch tfold_conv1")
    check(es <= 1e-4 and ea <= 1e-4,
          f"card vs CPU: scores {es}, adjacency {ea} beyond 1e-4")


def phase_serve(requests: list, direct: list, path: Path = CKPT,
                family: str = "d", phase: str = "serve") -> tuple:
    from cvad_tpu_torch.evaluation.http_service import (ScoringHTTPServer,
                                                        service_from_path)

    svc = service_from_path(str(path), family=family, buckets=BUCKETS)
    srv = ScoringHTTPServer(svc, port=0)
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        t0 = time.perf_counter()
        svc.warmup(dtypes=("float32", "uint8"))
        warm_s = time.perf_counter() - t0
        health = get(base + "/healthz")
        check(health["ok"] and health["buckets"] == list(BUCKETS), "healthz")

        replies: list = [None] * len(requests)

        def send(i: int) -> None:
            replies[i] = post(base + "/score", npz(requests[i]),
                              "application/octet-stream")

        # requests 0 and 1 go alone, 2 and 3 concurrently
        for i in (0, 1):
            send(i)
        pair = [threading.Thread(target=send, args=(i,)) for i in (2, 3)]
        for t in pair:
            t.start()
        for t in pair:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in pair), "concurrent requests hung")
        errs = []
        for clips, ref, rep in zip(requests, direct, replies):
            check(rep is not None and rep["n"] == len(clips),
                  f"reply n for a request of {len(clips)} clips")
            got = np.asarray(rep["scores"], np.float32)
            errs.append(float(np.abs(got - ref).max()))
            check(errs[-1] <= 1e-5,
                  f"served scores differ from the direct scorer by "
                  f"{errs[-1]}")
        stats = get(base + "/stats")
        check(stats["batches_total"] >= 1 and stats["errors_total"] == 0,
              f"stats {stats}")
        emit({"phase": phase, "family": family, "warmup_s": warm_s,
              "requests": [{"n": len(c), "dtype": str(c.dtype),
                            "max_abs_err_vs_direct": e}
                           for c, e in zip(requests, errs)],
              "stats": stats})
        return srv, base
    except BaseException:
        srv.close()
        raise


def phase_bulk(state: dict, clips: np.ndarray, ref: np.ndarray):
    from cvad_tpu_torch.evaluation.scoring import make_family_d_bulk_score_fn

    bulk = make_family_d_bulk_score_fn(state, batch=BULK_BATCH)
    s, adj = bulk(clips)
    err = float(np.abs(s - ref).max())
    emit({"phase": "bulk", "clips": len(clips), "dtype": "bfloat16",
          "batch": BULK_BATCH, "max_abs_err_vs_f32": err})
    check(s.shape == (len(clips),) and adj.shape == (len(clips), 16, 16),
          "bulk output shapes")
    check(bool(np.isfinite(s).all()), "bulk scores finite")
    check(err <= 2e-2, f"bf16 bulk vs f32 scores differ by {err}")
    return bulk


def counts() -> dict:
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1
    from cvad_tpu_torch.ops.pallas_kernels import (memory_min_cosine_distance,
                                                   pairwise_l1_mean)

    from cvad_tpu_torch.ops.flash_attention import flash_attention
    from cvad_tpu_torch.ops.pallas_s2d import s2d_fold_matmul, s2d_group_conv

    return {"tfold_conv1": tfold_conv1.launches,
            "pairwise_l1_forward": pairwise_l1_mean.launches,
            "pairwise_l1_backward": pairwise_l1_mean.backward_launches,
            "memory_min_cosine": memory_min_cosine_distance.launches,
            "s2d_group_forward": s2d_group_conv.launches,
            "s2d_group_wgrad": s2d_group_conv.backward_launches,
            "s2d_matmul_forward": s2d_fold_matmul.launches,
            "s2d_matmul_dgrad": s2d_fold_matmul.dgrad_launches,
            "s2d_matmul_wgrad": s2d_fold_matmul.wgrad_launches,
            "flash_forward": flash_attention.launches,
            "flash_dq": flash_attention.dq_launches,
            "flash_dkv": flash_attention.dkv_launches}


def reset_counts() -> None:
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1
    from cvad_tpu_torch.ops.pallas_kernels import (memory_min_cosine_distance,
                                                   pairwise_l1_mean)

    from cvad_tpu_torch.ops.flash_attention import flash_attention
    from cvad_tpu_torch.ops.pallas_s2d import s2d_fold_matmul, s2d_group_conv

    tfold_conv1.launches = 0
    pairwise_l1_mean.launches = pairwise_l1_mean.backward_launches = 0
    memory_min_cosine_distance.launches = 0
    s2d_group_conv.launches = s2d_group_conv.backward_launches = 0
    s2d_fold_matmul.launches = s2d_fold_matmul.dgrad_launches = 0
    s2d_fold_matmul.wgrad_launches = 0
    flash_attention.launches = flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0


def train_config(batch: int, **train):
    from cvad_tpu_torch.config import preset

    cfg = preset("family_d")
    return cfg.replace(
        data=cfg.data.replace(batch_size=batch, transfer_dtype="uint8"),
        train=cfg.train.replace(log_every=10**9, **train))


def phase_train_parity(state: dict, rng: np.random.Generator) -> None:
    """The same 3 float32 steps from the fixture on the card and on the
    CPU.  Tolerances: metrics rtol 1e-4 (cuDNN and CPU convolutions sum in
    other orders); parameters 5e-5, a tenth of lr, since Adam's first steps
    are close to lr * sign(g) and amplify rounding where g is near 0."""
    from cvad_tpu_torch.train.state import float_metrics
    from cvad_tpu_torch.train.tasks import build_task

    cfg = train_config(PARITY_BATCH)
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
    task = build_task(cfg)
    clips = rng.integers(0, 256, (PARITY_STEPS, PARITY_BATCH) + CLIP,
                         dtype=np.uint8)
    targets = (rng.uniform(size=(PARITY_STEPS, PARITY_BATCH)) < 0.25
               ).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        st = task.init_state(0, dev)  # fresh optimizer state: zero moments
        st.model.load_state_dict(state, strict=True)
        before, metrics = counts(), []
        for i in range(PARITY_STEPS):
            st, m = task.train_step(st, {
                "clips": torch.from_numpy(clips[i]).to(dev),
                "pseudo_targets": torch.from_numpy(targets[i]).to(dev)}, 1)
            metrics.append(float_metrics(m))
        rose = {k: v - before[k] for k, v in counts().items()}
        runs[dev] = (metrics, {k: v.cpu() for k, v in
                               st.model.state_dict().items()}, rose)
    (mg, pg, rose), (mc, pc, cpu_rose) = runs["cuda"], runs["cpu"]
    on_path = ("tfold_conv1", "pairwise_l1_forward", "pairwise_l1_backward")
    check(all(v == (PARITY_STEPS if k in on_path else 0)
              for k, v in rose.items()),
          f"card launches over {PARITY_STEPS} steps: {rose}")
    check(not any(cpu_rose.values()), f"CPU steps launched {cpu_rose}")
    err_m = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                for a, b in zip(mg, mc) for k in a)
    err_p = max((pg[k] - pc[k]).abs().max().item() for k in pg)
    emit({"phase": "train_parity", "batch": PARITY_BATCH,
          "steps": PARITY_STEPS, "card_launches": rose,
          "loss_card": [m["loss"] for m in mg],
          "loss_cpu": [m["loss"] for m in mc],
          "metrics_max_rel_err": err_m, "params_max_abs_err": err_p})
    check(err_m <= 1e-4, f"card vs CPU train metrics differ by {err_m}")
    check(err_p <= 5e-5, f"card vs CPU parameters differ by {err_p}")


def same_run(a, b) -> bool:
    sa, sb = a.state, b.state
    return (all(torch.equal(x, y) for x, y in
                zip(sa.model.state_dict().values(),
                    sb.model.state_dict().values()))
            and all(torch.equal(getattr(sa.opt_state, k),
                                getattr(sb.opt_state, k))
                    for k in ("mu", "nu", "count", "lr"))
            and sa.step == sb.step
            and a.history.as_dict() == b.history.as_dict())


def phase_train(workdir: Path) -> dict:
    """Main path 2: `Trainer.fit` on the card, an interrupted run resumed
    from its epoch-2 checkpoint, and the `best` checkpoint scored."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.evaluation.scoring import make_family_d_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.train.engine import Trainer
    from cvad_tpu_torch.train.state import param_count

    cfg = train_config(TRAIN_BATCH, num_epochs=TRAIN_EPOCHS, eval_every=1,
                       save_interval=1)
    t0 = time.perf_counter()
    # make_loaders' loaders, with the eval split cut to EVAL_CLIPS
    train_loader = BatchLoader(build_dataset(cfg.data, "Train", TRAIN_CLIPS),
                               TRAIN_BATCH, shuffle=True, seed=cfg.data.seed,
                               transfer_dtype="uint8")
    eval_loader = BatchLoader(build_dataset(cfg.data, "Test", EVAL_CLIPS),
                              TRAIN_BATCH, transfer_dtype="uint8")
    data_s = time.perf_counter() - t0
    score_clips = np.stack([eval_loader.dataset.get_uint8(i)[0] for i in
                            range(min(128, len(eval_loader.dataset)))])

    reset_counts()
    t0 = time.perf_counter()
    full = Trainer(cfg, out_dir=str(workdir / "full"))
    hist = full.fit(train_loader, eval_loader)
    fit_s = time.perf_counter() - t0
    first = Trainer(cfg.replace(train=cfg.train.replace(
        num_epochs=TRAIN_EPOCHS - 1)), out_dir=str(workdir / "resumed"))
    first.fit(train_loader, eval_loader)
    resumed = Trainer(cfg, out_dir=str(workdir / "resumed"))
    restored = resumed.restore()
    resumed.fit(train_loader, eval_loader)
    best = full.ckpt.path("best")
    scores, adj = make_family_d_score_fn(load_torch_state_dict(str(best)))(
        score_clips)
    ref = Trainer(cfg, out_dir=str(workdir / "ref"))
    ref.init_state()
    ref.state.load_state_dict(full.ckpt.restore("best"))
    want = ref.task.eval_step(ref.state, ref.put_batch(
        {"clips": score_clips}))
    torch.cuda.synchronize()
    launches = counts()

    steps = (2 * TRAIN_EPOCHS) * (TRAIN_CLIPS // TRAIN_BATCH)
    err_s = float(np.abs(scores - want["predictions"].cpu().numpy()).max())
    err_a = float(np.abs(adj - want["causal_graphs"].cpu().numpy()).max())
    bit_identical = same_run(full, resumed)
    n_params = param_count(full.state.model)
    emit({"phase": "train", "params": n_params, "batch": TRAIN_BATCH,
          "train_clips": TRAIN_CLIPS,
          "eval_clips": len(eval_loader.dataset), "epochs": TRAIN_EPOCHS,
          "train_steps": steps, "launches": launches,
          "synthetic_data_s": data_s, "fit_s": fit_s,
          "train_losses": hist["train_losses"],
          "eval_score_range": [e["score_range"]
                               for e in hist["evaluation_metrics"]],
          "resumed_from_epoch": restored,
          "resume_bit_identical": bit_identical,
          "best_checkpoint_score_err": err_s, "best_checkpoint_adj_err": err_a,
          "best_score_mean": float(scores.mean())})
    check(n_params == 188849, f"{n_params} parameters, not the shipped "
                              "model's 188,849")
    check(len(hist["epochs"]) == TRAIN_EPOCHS
          and all(np.isfinite(hist["train_losses"])), "train history")
    check(restored == TRAIN_EPOCHS - 1, f"restored epoch {restored}")
    check(bit_identical, "the resumed run differs from the uninterrupted one")
    check(scores.shape == (len(score_clips),)
          and bool(np.isfinite(scores).all()),
          "best checkpoint scores")
    check(err_s <= 1e-5 and err_a <= 1e-5,
          f"best checkpoint scorer vs eval step: {err_s}, {err_a}")
    check(launches["pairwise_l1_forward"] == steps
          and launches["pairwise_l1_backward"] == steps,
          f"K2 launches {launches} for {steps} train steps")
    check(launches["tfold_conv1"] >= steps,
          f"K1 launches {launches} for {steps} train steps")
    return launches


def long_config(batch: int, conv1_mode: str = "auto", **train):
    """Family D on 64-frame windows with conv_group_impl='s2d': conv1 runs K5
    on the card ('auto' resolves to 'tfold' there); conv1_mode='tfold' takes
    the K5 route on the CPU too."""
    cfg = train_config(batch, **train)
    return cfg.replace(
        data=cfg.data.replace(clip_len=LONG_CLIP[0]),
        model=cfg.model.replace(conv_group_impl="s2d", conv1_mode=conv1_mode))


def phase_long_model(state: dict, clips: np.ndarray) -> dict:
    """Main path 5, scoring: the fixture scores 64-frame clips on the card
    through the K5 route, the launch counts set to 0 just before and read
    just after.  Then, outside that window, the K1 route on the card and
    the K5 route's plain version on the CPU (TF32 off): scores and
    adjacency within 1e-4.  Returns the main path's launch counts."""
    from cvad_tpu_torch.evaluation.scoring import make_family_d_score_fn

    cfg = long_config(LONG_BATCH, conv1_mode="tfold").model
    reset_counts()
    s5, a5 = make_family_d_score_fn(state, cfg)(clips)
    k5 = counts()
    s1, a1 = make_family_d_score_fn(state)(clips)  # default lowering: K1
    k1 = {k: v - k5[k] for k, v in counts().items()}
    sc, ac = make_family_d_score_fn(state, cfg, device="cpu")(clips)
    errs = {"score_vs_k1": float(np.abs(s5 - s1).max()),
            "adj_vs_k1": float(np.abs(a5 - a1).max()),
            "score_vs_cpu": float(np.abs(s5 - sc).max()),
            "adj_vs_cpu": float(np.abs(a5 - ac).max())}
    emit({"phase": "long_model", "clips": len(clips),
          "clip": list(clips.shape[1:]), "k5_route_launches": k5,
          "k1_route_launches": k1, **errs,
          "score_mean": float(s5.mean()),
          "edges_per_graph": float((a5 > 0.1).sum((1, 2)).mean())})
    check(s5.shape == (len(clips),) and a5.shape == (len(clips), 16, 16)
          and bool(np.isfinite(s5).all() and np.isfinite(a5).all()),
          "long-window scores and adjacency")
    check(k5["s2d_group_forward"] == 1 and k5["tfold_conv1"] == 0,
          f"the K5 route launched {k5}")
    check(k1["tfold_conv1"] == 1 and k1["s2d_group_forward"] == 0,
          f"the K1 route launched {k1}")
    check(max(errs.values()) <= 1e-4, f"long-window scores differ: {errs}")
    return k5


def step_grads(cfg, model, clips: np.ndarray, targets: np.ndarray,
               step: int, dtype: torch.dtype = torch.float32) -> dict:
    """The gradient of one family-D train step at `model`'s parameters on
    one batch: `train/tasks.py`'s train_step up to `autograd.grad`, without
    the update (the same prep, generator seed, loss and cuDNN flags), on
    the model's device; returned on the CPU by parameter name.  With
    dtype=torch.float64 a float64 copy of the model takes the prepped
    clips and the labels cast to float64: on the CPU the K5 route and K2
    then run their plain versions in float64."""
    from cvad_tpu_torch.ops.losses import improved_loss
    from cvad_tpu_torch.train.tasks import card_numerics, prep_clips, step_seed

    dev = next(model.parameters()).device
    if next(model.parameters()).dtype != dtype:
        model = copy.deepcopy(model).to(dtype)
    x = prep_clips(torch.from_numpy(clips).to(dev),
                   cfg.data.normalize_clamp).to(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(step_seed(1, step))
    names, params = zip(*model.named_parameters())
    with card_numerics():
        scores, adj, _ = model.train()(x, generator=gen)
        total, _ = improved_loss(scores, adj,
                                 torch.from_numpy(targets).to(dev, dtype),
                                 cfg.loss)
        grads = torch.autograd.grad(total, params)
    return {n: g.detach().cpu() for n, g in zip(names, grads)}


def rel_errs(got: dict, ref: dict) -> dict:
    """Each leaf's largest |got - ref| over its largest |ref| entry."""
    return {n: (got[n].double() - g).abs().max().item()
            / max(g.abs().max().item(), 1e-30) for n, g in ref.items()}


def long_parity_data(rng: np.random.Generator) -> tuple:
    """long_train_parity's uint8 clips and pseudo-labels: PARITY_STEPS
    batches of LONG_PARITY_BATCH clips, drawn from `rng`."""
    clips = rng.integers(0, 256, (PARITY_STEPS, LONG_PARITY_BATCH)
                         + LONG_CLIP, dtype=np.uint8)
    targets = (rng.uniform(size=(PARITY_STEPS, LONG_PARITY_BATCH)) < 0.25
               ).astype(np.float32)
    return clips, targets


def long_grad_parity(task, cfg, clips: np.ndarray, targets: np.ndarray,
                     witness: tuple = ()) -> tuple:
    """Per-step gradients from the same parameters, held against float64.
    The CPU runs the steps from seed 0 in float32; before each it takes
    the step's float32 gradient and, from a float64 copy of the same
    parameters, its float64 gradient.  The card takes the float32
    gradient at those parameters on the same batch, and so does the
    `witness` model on the card, where one is given as (config, model).
    Returns, for each step, every leaf's e_card and e_cpu (and e_witness):
    the largest difference of the card's (the CPU's float32, the
    witness's) gradient from the float64 one over its largest entry; the
    card's launches over its gradient calls (the witness's not counted);
    and the CPU run's metrics and final state."""
    from cvad_tpu_torch.train.state import float_metrics

    cpu = task.init_state(0, "cpu")
    card = task.init_state(0, "cuda").model
    launched = dict.fromkeys(counts(), 0)
    steps, metrics = [], []
    for i in range(clips.shape[0]):
        args = (clips[i], targets[i], cpu.step)
        g32 = step_grads(cfg, cpu.model, *args)
        g64 = step_grads(cfg, cpu.model, *args, dtype=torch.float64)
        card.load_state_dict(cpu.model.state_dict(), strict=True)
        before = counts()
        got = step_grads(cfg, card, *args)
        for k, v in counts().items():
            launched[k] += v - before[k]
        errs = {"e_card": rel_errs(got, g64), "e_cpu": rel_errs(g32, g64)}
        if witness:
            wcfg, wmodel = witness
            wmodel.load_state_dict(cpu.model.state_dict(), strict=True)
            errs["e_witness"] = rel_errs(step_grads(wcfg, wmodel, *args),
                                         g64)
        steps.append({n: {k: e[n] for k, e in errs.items()} for n in g64})
        cpu, m = task.train_step(cpu, {
            "clips": torch.from_numpy(clips[i]),
            "pseudo_targets": torch.from_numpy(targets[i])}, 1)
        metrics.append(float_metrics(m))
    return steps, launched, metrics, cpu.model.state_dict()


def grad_bound(e_cpu: float) -> float:
    """long_train_parity's bound on a leaf's e_card."""
    return GRAD_ABS + GRAD_KAPPA * e_cpu


def worst_leaf(step: dict) -> dict:
    """The leaf of one step of `long_grad_parity` whose e_card takes the
    largest share of its bound, with e_card, e_cpu and their ratio."""
    name = max(step, key=lambda n: step[n]["e_card"]
               / grad_bound(step[n]["e_cpu"]))
    e = step[name]
    return {"leaf": name, **e,
            "card_over_cpu": e["e_card"] / max(e["e_cpu"], 1e-30),
            "share_of_bound": e["e_card"] / grad_bound(e["e_cpu"])}


def phase_long_train_parity() -> None:
    """3 float32 steps at T=64, B=8 from seed 0 on the card and on the CPU,
    both on the K5 route, dropout 0 and injected pseudo-labels drawn from
    the phase's own generator (LONG_PARITY_SEED).  Metrics within rtol
    1e-4 over the two runs; each card step launches K5's forward and
    weight gradient and K2's forward and backward once, K1 never.  The
    parameters after 3 Adam steps are reported, not bounded: where a
    gradient is near 0, Adam's first steps (about lr * sign(g)) turn
    float32 rounding into differences of a good share of lr on some
    data.  What is bounded is each step's gradient from the same
    parameters, against float64 arithmetic: at each of the 3 steps the
    card computes the float32 gradient at the CPU run's parameters on that
    step's batch, the CPU its float32 and float64 gradients there, and for
    every leaf e_card <= GRAD_ABS + GRAD_KAPPA * e_cpu, e_x being the
    largest |x - float64| over the largest |float64| entry.  The card may
    lie farther from exact arithmetic than the CPU's own float32 only by
    the factor GRAD_KAPPA, and by GRAD_ABS (the rule of the kernels' own
    checks) beside it: float32 sums in another order, not a fault."""
    from cvad_tpu_torch.train.state import float_metrics
    from cvad_tpu_torch.train.tasks import build_task

    cfg = long_config(LONG_PARITY_BATCH, conv1_mode="tfold")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
    task = build_task(cfg)
    clips, targets = long_parity_data(np.random.default_rng(LONG_PARITY_SEED))
    st = task.init_state(0, "cuda")
    before, mg = counts(), []
    for i in range(PARITY_STEPS):
        st, m = task.train_step(st, {
            "clips": torch.from_numpy(clips[i]).cuda(),
            "pseudo_targets": torch.from_numpy(targets[i]).cuda()}, 1)
        mg.append(float_metrics(m))
    rose = {k: v - before[k] for k, v in counts().items()}
    pg = {k: v.cpu() for k, v in st.model.state_dict().items()}
    # the CPU steps, and the card's gradients at their parameters
    grads, grad_rose, mc, pc = long_grad_parity(task, cfg, clips, targets)
    on_path = ("s2d_group_forward", "s2d_group_wgrad", "pairwise_l1_forward",
               "pairwise_l1_backward")
    check(all(v == (PARITY_STEPS if k in on_path else 0)
              for k, v in rose.items()),
          f"card launches over {PARITY_STEPS} long-window steps: {rose}")
    check(all(v == (PARITY_STEPS if k in on_path else 0)
              for k, v in grad_rose.items()),
          f"card launches over {PARITY_STEPS} gradients: {grad_rose}")
    err_m = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                for a, b in zip(mg, mc) for k in a)
    err_p = max((pg[k] - pc[k]).abs().max().item() for k in pg)
    emit({"phase": "long_train_parity", "batch": LONG_PARITY_BATCH,
          "clip": list(LONG_CLIP), "steps": PARITY_STEPS,
          "data_seed": LONG_PARITY_SEED, "card_launches": rose,
          "loss_card": [m["loss"] for m in mg],
          "loss_cpu": [m["loss"] for m in mc],
          "metrics_max_rel_err": err_m, "params_max_abs_err": err_p,
          "grad_bound": {"abs": GRAD_ABS, "kappa": GRAD_KAPPA},
          "grad_worst_leaf_by_step": [worst_leaf(g) for g in grads]})
    check(err_m <= 1e-4, f"long-window card vs CPU metrics differ by {err_m}")
    for i, step in enumerate(grads):
        for name, e in step.items():
            check(e["e_card"] <= grad_bound(e["e_cpu"]),
                  f"long-window step {i + 1}: the card's gradient of {name} "
                  f"lies {e['e_card']} of its largest entry from float64, "
                  f"the CPU's float32 {e['e_cpu']}: past {GRAD_ABS} + "
                  f"{GRAD_KAPPA} x {e['e_cpu']}")


def phase_long_train(workdir: Path) -> dict:
    """Main path 5: `Trainer.fit` at T=64, B=128 on the card with
    conv_group_impl='s2d' (K5), an interrupted run resumed from its epoch-2
    checkpoint, and the `best` checkpoint scored by the long-window
    scorer."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.evaluation.scoring import make_family_d_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.train.engine import Trainer
    from cvad_tpu_torch.train.state import param_count

    cfg = long_config(LONG_BATCH, num_epochs=TRAIN_EPOCHS, eval_every=1,
                      save_interval=1)
    t0 = time.perf_counter()
    train_loader = BatchLoader(
        build_dataset(cfg.data, "Train", LONG_TRAIN_CLIPS), LONG_BATCH,
        shuffle=True, seed=cfg.data.seed, transfer_dtype="uint8")
    eval_loader = BatchLoader(
        build_dataset(cfg.data, "Test", LONG_EVAL_CLIPS), LONG_BATCH,
        transfer_dtype="uint8")
    data_s = time.perf_counter() - t0
    score_clips = np.stack([eval_loader.dataset.get_uint8(i)[0]
                            for i in range(len(eval_loader.dataset))])

    reset_counts()
    t0 = time.perf_counter()
    full = Trainer(cfg, out_dir=str(workdir / "long_full"))
    hist = full.fit(train_loader, eval_loader)
    fit_s = time.perf_counter() - t0
    first = Trainer(cfg.replace(train=cfg.train.replace(
        num_epochs=TRAIN_EPOCHS - 1)), out_dir=str(workdir / "long_resumed"))
    first.fit(train_loader, eval_loader)
    resumed = Trainer(cfg, out_dir=str(workdir / "long_resumed"))
    restored = resumed.restore()
    resumed.fit(train_loader, eval_loader)
    best = full.ckpt.path("best")
    scores, adj = make_family_d_score_fn(load_torch_state_dict(str(best)),
                                         cfg.model)(score_clips)
    ref = Trainer(cfg, out_dir=str(workdir / "long_ref"))
    ref.init_state()
    ref.state.load_state_dict(full.ckpt.restore("best"))
    want = ref.task.eval_step(ref.state, ref.put_batch(
        {"clips": score_clips}))
    torch.cuda.synchronize()
    launches = counts()

    steps = (2 * TRAIN_EPOCHS) * (LONG_TRAIN_CLIPS // LONG_BATCH)
    err_s = float(np.abs(scores - want["predictions"].cpu().numpy()).max())
    err_a = float(np.abs(adj - want["causal_graphs"].cpu().numpy()).max())
    bit_identical = same_run(full, resumed)
    n_params = param_count(full.state.model)
    emit({"phase": "long_train", "params": n_params, "batch": LONG_BATCH,
          "clip": list(LONG_CLIP), "train_clips": LONG_TRAIN_CLIPS,
          "eval_clips": len(eval_loader.dataset), "epochs": TRAIN_EPOCHS,
          "train_steps": steps, "launches": launches,
          "synthetic_data_s": data_s, "fit_s": fit_s,
          "train_losses": hist["train_losses"],
          "eval_score_range": [e["score_range"]
                               for e in hist["evaluation_metrics"]],
          "resumed_from_epoch": restored,
          "resume_bit_identical": bit_identical,
          "best_checkpoint_score_err": err_s, "best_checkpoint_adj_err": err_a,
          "best_score_mean": float(scores.mean())})
    check(n_params == 188849, f"{n_params} parameters, not the shipped "
                              "model's 188,849")
    check(len(hist["epochs"]) == TRAIN_EPOCHS
          and all(np.isfinite(hist["train_losses"])), "long-window history")
    check(restored == TRAIN_EPOCHS - 1, f"restored epoch {restored}")
    check(bit_identical,
          "the resumed long-window run differs from the uninterrupted one")
    check(scores.shape == (len(score_clips),)
          and bool(np.isfinite(scores).all()), "best checkpoint scores")
    check(err_s <= 1e-5 and err_a <= 1e-5,
          f"long-window best checkpoint scorer vs eval step: {err_s}, "
          f"{err_a}")
    check(launches["s2d_group_wgrad"] == steps
          and launches["s2d_group_forward"] > steps
          and launches["pairwise_l1_forward"] == steps
          and launches["pairwise_l1_backward"] == steps
          and launches["tfold_conv1"] == 0,
          f"main path 5 launches {launches} for {steps} train steps")
    return launches


def b_train_config(batch: int, **train):
    from cvad_tpu_torch.config import preset

    cfg = preset("memory_ae")
    return cfg.replace(
        data=cfg.data.replace(batch_size=batch, transfer_dtype="uint8"),
        train=cfg.train.replace(log_every=10**9, **train))


def b_checkpoint_state(rng: np.random.Generator) -> dict:
    """A family-B state dict: random init from seed 0 and B_FILL bank rows
    drawn from `rng`."""
    from cvad_tpu_torch.models import MemoryVideoAutoEncoder
    from cvad_tpu_torch.models.family_b import MemoryBankState

    model = MemoryVideoAutoEncoder(seed=0)
    memory = torch.zeros(500, 64)
    memory[:B_FILL] = torch.from_numpy(
        rng.normal(size=(B_FILL, 64)).astype(np.float32))
    fill = torch.tensor(B_FILL, dtype=torch.int32)
    model.set_memory_bank(MemoryBankState(memory, fill, fill))
    return model.state_dict()


def phase_family_b_model(rng: np.random.Generator) -> None:
    """The family-B scorer and forward on the card against the CPU."""
    from cvad_tpu_torch.evaluation.scoring import make_family_b_score_fn
    from cvad_tpu_torch.models import MemoryVideoAutoEncoder
    from cvad_tpu_torch.ops.pallas_kernels import memory_min_cosine_distance

    state = b_checkpoint_state(rng)
    clips = rng.uniform(0, 1, (128,) + CLIP_B).astype(np.float32)
    before = memory_min_cosine_distance.launches
    s_gpu = make_family_b_score_fn(state)(clips)
    rose = memory_min_cosine_distance.launches - before
    s_cpu = make_family_b_score_fn(state, device="cpu")(clips)
    x = torch.from_numpy(clips).permute(0, 1, 4, 2, 3).contiguous()
    outs = {}
    for dev in ("cuda", "cpu"):
        model = MemoryVideoAutoEncoder()
        model.load_state_dict(state, strict=True)
        model = model.to(dev).eval()
        with torch.no_grad(), no_tf32():
            outs[dev] = {k: v.cpu() for k, v in model(x.to(dev)).items()}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in outs["cpu"]}
    es = float(np.abs(s_gpu - s_cpu).max())
    emit({"phase": "family_b_model", "clips": len(clips), "bank_fill": B_FILL,
          "k3_launches": rose, "score_max_abs_err": es,
          "output_max_abs_err": errs, "score_mean": float(s_gpu.mean()),
          "memory_score_mean": float(outs["cuda"]["anomaly_score"].mean())})
    check(s_gpu.shape == (len(clips),) and bool(np.isfinite(s_gpu).all()),
          "family-B scores")
    check(rose > 0, "the family-B scorer did not launch memory_min_cosine")
    check(es <= 1e-4 and max(errs.values()) <= 1e-4,
          f"family B card vs CPU: scores {es}, outputs {errs}")


def phase_family_b_parity(rng: np.random.Generator) -> None:
    """The same 3 float32 family-B steps from seed 0 on the card and on the
    CPU, with the train split's share of normal clips.  Tolerances as
    train_parity's; the state compared is the whole state dict (parameters,
    BatchNorm statistics, bank)."""
    from cvad_tpu_torch.train.state import float_metrics
    from cvad_tpu_torch.train.tasks import build_task

    task = build_task(b_train_config(PARITY_BATCH))
    clips = rng.integers(0, 256, (PARITY_STEPS, PARITY_BATCH) + CLIP_B,
                         dtype=np.uint8)
    labels = (rng.uniform(size=(PARITY_STEPS, PARITY_BATCH))
              < B_ANOMALY_RATE).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        st = task.init_state(0, dev)
        before, metrics = counts(), []
        for i in range(PARITY_STEPS):
            st, m = task.train_step(st, {
                "clips": torch.from_numpy(clips[i]).to(dev),
                "labels": torch.from_numpy(labels[i]).to(dev)}, 1)
            metrics.append(float_metrics(m))
        rose = {k: v - before[k] for k, v in counts().items()}
        runs[dev] = (metrics, {k: v.cpu() for k, v in
                               st.model.state_dict().items()}, rose)
    (mg, pg, rose), (mc, pc, cpu_rose) = runs["cuda"], runs["cpu"]
    check(not any(rose.values()) and not any(cpu_rose.values()),
          f"family-B train steps launched {rose}, {cpu_rose}: the step "
          f"computes no memory score")
    err_m = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                for a, b in zip(mg, mc) for k in a)
    err_p = max((pg[k].double() - pc[k].double()).abs().max().item()
                for k in pg)
    emit({"phase": "family_b_parity", "batch": PARITY_BATCH,
          "steps": PARITY_STEPS, "loss_card": [m["loss"] for m in mg],
          "loss_cpu": [m["loss"] for m in mc],
          "n_normal": [m["n_normal"] for m in mg],
          "metrics_max_rel_err": err_m, "state_max_abs_err": err_p})
    check(err_m <= 1e-4, f"family B card vs CPU metrics differ by {err_m}")
    check(err_p <= 5e-5, f"family B card vs CPU state differs by {err_p}")


def phase_family_b_train(workdir: Path) -> tuple:
    """Main path 3: `Trainer.fit` with the memory_ae preset on the card, an
    interrupted run resumed from its epoch-2 checkpoint, and the `best`
    checkpoint scored.  Returns the launch counts and the best path."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.evaluation.scoring import make_family_b_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.train.engine import Trainer
    from cvad_tpu_torch.train.state import param_count

    cfg = b_train_config(TRAIN_BATCH, num_epochs=TRAIN_EPOCHS, eval_every=1,
                         save_interval=1)
    t0 = time.perf_counter()
    train_loader = BatchLoader(build_dataset(cfg.data, "Train", TRAIN_CLIPS),
                               TRAIN_BATCH, shuffle=True, seed=cfg.data.seed,
                               transfer_dtype="uint8")
    eval_loader = BatchLoader(build_dataset(cfg.data, "Test", EVAL_CLIPS),
                              TRAIN_BATCH, transfer_dtype="uint8")
    data_s = time.perf_counter() - t0
    # float clips inside the preset's clamp, so that the scorer (which does
    # not clamp) and the eval step (which does) see the same inputs
    score_clips = np.stack([eval_loader.dataset[i][0] for i in
                            range(min(128, len(eval_loader.dataset)))])
    n_normal = int((train_loader.dataset.labels == 0).sum())

    reset_counts()
    t0 = time.perf_counter()
    full = Trainer(cfg, out_dir=str(workdir / "b_full"))
    hist = full.fit(train_loader, eval_loader)
    fit_s = time.perf_counter() - t0
    first = Trainer(cfg.replace(train=cfg.train.replace(
        num_epochs=TRAIN_EPOCHS - 1)), out_dir=str(workdir / "b_resumed"))
    first.fit(train_loader, eval_loader)
    resumed = Trainer(cfg, out_dir=str(workdir / "b_resumed"))
    restored = resumed.restore()
    resumed.fit(train_loader, eval_loader)
    best = full.ckpt.path("best")
    scores = make_family_b_score_fn(load_torch_state_dict(str(best)))(
        score_clips)
    ref = Trainer(cfg, out_dir=str(workdir / "b_ref"))
    ref.init_state()
    ref.state.load_state_dict(full.ckpt.restore("best"))
    want = ref.task.eval_step(ref.state, ref.put_batch(
        {"clips": score_clips,
         "labels": np.zeros(len(score_clips), np.float32)}))
    torch.cuda.synchronize()
    launches = counts()

    steps = (2 * TRAIN_EPOCHS) * (TRAIN_CLIPS // TRAIN_BATCH)
    err = float(np.abs(scores - want["predictions"].cpu().numpy()).max())
    a, b = full.ckpt.restore(TRAIN_EPOCHS), resumed.ckpt.restore(TRAIN_EPOCHS)
    ckpt_same = all(torch.equal(v, b[part][k]) for part in
                    ("model_state_dict", "optimizer")
                    for k, v in a[part].items())
    bit_identical = same_run(full, resumed) and ckpt_same
    bank = a["model_state_dict"]
    n_params = param_count(full.state.model)
    evals = hist["evaluation_metrics"]
    emit({"phase": "family_b_train", "params": n_params, "batch": TRAIN_BATCH,
          "train_clips": TRAIN_CLIPS, "normal_train_clips": n_normal,
          "eval_clips": len(eval_loader.dataset), "epochs": TRAIN_EPOCHS,
          "train_steps": steps, "launches": launches,
          "synthetic_data_s": data_s, "fit_s": fit_s,
          "train_losses": hist["train_losses"],
          "val_loss": [e["val_loss"] for e in evals],
          "auc": [e["auc"] for e in evals], "best_val_loss": full._best,
          "bank_after_epoch_3": {"ptr": int(bank["memory_ptr"]),
                                 "fill": int(bank["memory_fill"])},
          "resumed_from_epoch": restored,
          "resume_bit_identical": bit_identical,
          "best_checkpoint_score_err": err,
          "best_score_mean": float(scores.mean())})
    check(n_params == 1152001, f"{n_params} family-B parameters, not the "
                               "published width's 1,152,001")
    check(len(hist["epochs"]) == TRAIN_EPOCHS
          and all(np.isfinite(hist["train_losses"]))
          and all(np.isfinite(e["val_loss"]) for e in evals),
          "family-B train history")
    check(full._best == min(e["val_loss"] for e in evals),
          "best checkpoint is not the least val_loss")
    written = TRAIN_EPOCHS * n_normal  # the bank wraps past 500
    check(int(bank["memory_fill"]) == min(written, 500)
          and int(bank["memory_ptr"]) == written % 500,
          f"bank after {TRAIN_EPOCHS} epochs: {bank['memory_ptr']}, "
          f"{bank['memory_fill']}")
    check(restored == TRAIN_EPOCHS - 1, f"restored epoch {restored}")
    check(bit_identical,
          "the resumed family-B run differs from the uninterrupted one")
    check(scores.shape == (len(score_clips),)
          and bool(np.isfinite(scores).all()), "best checkpoint scores")
    check(err <= 1e-5, f"best checkpoint scorer vs eval step: {err}")
    check(launches["memory_min_cosine"] >= 1,
          f"main path 3 launched memory_min_cosine {launches}")
    return launches, best


def attn_config(batch: int, **train):
    """memory_ae with the attention encoder at bench.py's flash
    configuration (latent 128, one head, 2 layers) on 128-frame clips: on
    the card every attention runs K6."""
    cfg = b_train_config(batch, **train)
    return cfg.replace(model=cfg.model.replace(**ATTN_MODEL),
                       data=cfg.data.replace(clip_len=ATTN_CLIP[0]))


def phase_attn_model(rng: np.random.Generator) -> None:
    """The attention model (seed 0, B_FILL bank rows of width 128) scores
    ATTN_SCORE_CLIPS 128-frame clips on the card and on the CPU, TF32 off:
    the scorer within 1e-4, and the forward's outputs within 1e-4."""
    from cvad_tpu_torch.evaluation.scoring import make_family_b_score_fn
    from cvad_tpu_torch.models import MemoryVideoAutoEncoder
    from cvad_tpu_torch.models.family_b import MemoryBankState

    cfg = attn_config(ATTN_BATCH).model
    model = MemoryVideoAutoEncoder(cfg, seed=0)
    width = cfg.latent_dim
    memory = torch.zeros(cfg.memory_size, width)
    memory[:B_FILL] = torch.from_numpy(
        rng.normal(size=(B_FILL, width)).astype(np.float32))
    fill = torch.tensor(B_FILL, dtype=torch.int32)
    model.set_memory_bank(MemoryBankState(memory, fill, fill))
    state = model.state_dict()
    clips = rng.uniform(0, 1, (ATTN_SCORE_CLIPS,) + ATTN_CLIP).astype(
        np.float32)
    before = counts()
    s_gpu = make_family_b_score_fn(state, cfg=cfg)(clips)
    rose = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    s_cpu = make_family_b_score_fn(state, cfg=cfg, device="cpu")(clips)
    x = torch.from_numpy(clips).permute(0, 1, 4, 2, 3).contiguous()
    outs = {}
    for dev in ("cuda", "cpu"):
        m = MemoryVideoAutoEncoder(cfg)
        m.load_state_dict(state, strict=True)
        m = m.to(dev).eval()
        with torch.no_grad(), no_tf32():
            outs[dev] = {k: v.cpu() for k, v in m(x.to(dev)).items()}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in outs["cpu"]}
    es = float(np.abs(s_gpu - s_cpu).max())
    emit({"phase": "attn_model", "clips": len(clips),
          "clip": list(ATTN_CLIP), "bank": list(memory.shape),
          "bank_fill": B_FILL, "scorer_launches": rose,
          "score_max_abs_err": es, "output_max_abs_err": errs,
          "score_mean": float(s_gpu.mean()),
          "memory_score_mean": float(outs["cuda"]["anomaly_score"].mean())})
    check(s_gpu.shape == (len(clips),) and bool(np.isfinite(s_gpu).all()),
          "attention-model scores")
    check(outs["cuda"]["sequence_feature"].shape == (len(clips), width),
          "sequence feature width")
    check(rose.get("flash_forward") == cfg.attn_layers
          and rose.get("memory_min_cosine") == 1
          and not rose.get("flash_dq") and not rose.get("flash_dkv"),
          f"the attention scorer launched {rose}")
    check(es <= 1e-4 and max(errs.values()) <= 1e-4,
          f"attention model card vs CPU: scores {es}, outputs {errs}")


def phase_attn_parity(rng: np.random.Generator) -> None:
    """The same 3 float32 steps of the attention model at B=4, T=128 from
    seed 0 on the card and on the CPU, with the train split's share of
    normal clips; tolerances as family_b_parity's.  Each card step launches
    K6's forward and its two backward kernels once a layer."""
    from cvad_tpu_torch.train.state import float_metrics
    from cvad_tpu_torch.train.tasks import build_task

    cfg = attn_config(ATTN_PARITY_BATCH)
    task = build_task(cfg)
    clips = rng.integers(0, 256, (PARITY_STEPS, ATTN_PARITY_BATCH)
                         + ATTN_CLIP, dtype=np.uint8)
    labels = (rng.uniform(size=(PARITY_STEPS, ATTN_PARITY_BATCH))
              < B_ANOMALY_RATE).astype(np.float32)
    labels[:, 0] = 0.0  # every step trains on at least one clip
    runs = {}
    for dev in ("cuda", "cpu"):
        st = task.init_state(0, dev)
        before, metrics = counts(), []
        for i in range(PARITY_STEPS):
            st, m = task.train_step(st, {
                "clips": torch.from_numpy(clips[i]).to(dev),
                "labels": torch.from_numpy(labels[i]).to(dev)}, 1)
            metrics.append(float_metrics(m))
        rose = {k: v - before[k] for k, v in counts().items()}
        runs[dev] = (metrics, {k: v.cpu() for k, v in
                               st.model.state_dict().items()}, rose)
    (mg, pg, rose), (mc, pc, cpu_rose) = runs["cuda"], runs["cpu"]
    per_step = PARITY_STEPS * cfg.model.attn_layers
    on_path = ("flash_forward", "flash_dq", "flash_dkv")
    check(all(v == (per_step if k in on_path else 0)
              for k, v in rose.items()),
          f"card launches over {PARITY_STEPS} attention steps: {rose}")
    check(not any(cpu_rose.values()), f"CPU steps launched {cpu_rose}")
    err_m = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                for a, b in zip(mg, mc) for k in a)
    err_p = max((pg[k].double() - pc[k].double()).abs().max().item()
                for k in pg)
    emit({"phase": "attn_parity", "batch": ATTN_PARITY_BATCH,
          "clip": list(ATTN_CLIP), "steps": PARITY_STEPS,
          "card_launches": rose, "loss_card": [m["loss"] for m in mg],
          "loss_cpu": [m["loss"] for m in mc],
          "n_normal": [m["n_normal"] for m in mg],
          "metrics_max_rel_err": err_m, "state_max_abs_err": err_p})
    check(err_m <= 1e-4, f"attention card vs CPU metrics differ by {err_m}")
    check(err_p <= 5e-5, f"attention card vs CPU state differs by {err_p}")


def card_cpu_step(cfg, batch: dict) -> dict:
    """One float32 train step of `cfg`'s task from the seed-0 init on the
    card and on the CPU, on the same numpy batch: the metrics' largest
    relative difference, the state's largest absolute difference, and the
    card's launches by kernel."""
    from cvad_tpu_torch.train.state import float_metrics
    from cvad_tpu_torch.train.tasks import build_task

    task = build_task(cfg)
    runs = {}
    for dev in ("cuda", "cpu"):
        st = task.init_state(0, dev)
        before = counts()
        st, m = task.train_step(st, {k: torch.from_numpy(v).to(dev)
                                     for k, v in batch.items()}, 1)
        rose = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        runs[dev] = (float_metrics(m), {k: v.cpu() for k, v in
                                        st.model.state_dict().items()}, rose)
    (mg, pg, rose), (mc, pc, cpu_rose) = runs["cuda"], runs["cpu"]
    check(not cpu_rose, f"CPU step launched {cpu_rose}")
    return {"loss_card": mg["loss"], "loss_cpu": mc["loss"],
            "metrics_max_rel_err": max(abs(mg[k] - mc[k])
                                       / max(abs(mc[k]), 1e-6) for k in mg),
            "state_max_abs_err": max((pg[k].double() - pc[k].double())
                                     .abs().max().item() for k in pg),
            "card_launches": rose}


def phase_widths(rng: np.random.Generator) -> None:
    """Configurations `cvad_tpu` runs whose widths K1, K6, K2 or K3 did not
    take before: family D with grayscale clips (in_channels=1) at T=8 and
    at T=64 on the default lowering, and with conv_channels=(32, 32, 64),
    conv1 on F.conv3d (no K1 launch); family B with the attention encoder
    at latent 256 with one head (K6 at head dim 256) at T=128.  One float32
    step each from the seed-0 init, card against CPU, at attn_parity's
    tolerances: metrics rtol 1e-4, state 5e-5."""
    b = 4
    cases = []
    for name, model, clip in (
            ("d_gray_t8", dict(in_channels=1), (8, 64, 64, 1)),
            ("d_gray_t64", dict(in_channels=1), (64, 64, 64, 1)),
            ("d_conv32", dict(conv_channels=(32, 32, 64)), CLIP)):
        cfg = train_config(b)
        cfg = cfg.replace(model=cfg.model.replace(dropout=0.0, **model),
                          data=cfg.data.replace(clip_len=clip[0]))
        r = card_cpu_step(cfg, {
            "clips": rng.integers(0, 256, (b,) + clip, dtype=np.uint8),
            "pseudo_targets": (rng.uniform(size=b) < 0.25).astype(
                np.float32)})
        check(not r["card_launches"].get("tfold_conv1")
              and r["card_launches"].get("pairwise_l1_forward") == 1,
              f"{name} launched {r['card_launches']}")
        cases.append({"case": name, **r})
    cfg = b_train_config(2)
    cfg = cfg.replace(model=cfg.model.replace(**WIDE_HEAD),
                      data=cfg.data.replace(clip_len=ATTN_CLIP[0]))
    labels = np.array([0.0, 1.0], np.float32)
    r = card_cpu_step(cfg, {"clips": rng.integers(
        0, 256, (2,) + ATTN_CLIP, dtype=np.uint8), "labels": labels})
    layers = cfg.model.attn_layers
    check(all(r["card_launches"].get(k) == layers for k in
              ("flash_forward", "flash_dq", "flash_dkv")),
          f"wide-head step launched {r['card_launches']}")
    cases.append({"case": "b_attn_head256", **r})
    emit({"phase": "widths", "cases": cases})
    for c in cases:
        check(c["metrics_max_rel_err"] <= 1e-4
              and c["state_max_abs_err"] <= 5e-5,
              f"{c['case']}: card vs CPU metrics {c['metrics_max_rel_err']},"
              f" state {c['state_max_abs_err']}")


def phase_attn_train(workdir: Path) -> dict:
    """Main path 6: `Trainer.fit` with the attention model on 128-frame
    clips, an interrupted run resumed from its epoch-2 checkpoint, and the
    `best` checkpoint scored by `make_family_b_score_fn(cfg=...)`."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.evaluation.scoring import make_family_b_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.train.engine import Trainer
    from cvad_tpu_torch.train.state import param_count

    cfg = attn_config(ATTN_BATCH, num_epochs=TRAIN_EPOCHS, eval_every=1,
                      save_interval=1)
    t0 = time.perf_counter()
    train_loader = BatchLoader(
        build_dataset(cfg.data, "Train", ATTN_TRAIN_CLIPS), ATTN_BATCH,
        shuffle=True, seed=cfg.data.seed, transfer_dtype="uint8")
    eval_loader = BatchLoader(
        build_dataset(cfg.data, "Test", ATTN_EVAL_CLIPS), ATTN_BATCH,
        transfer_dtype="uint8")
    data_s = time.perf_counter() - t0
    # float clips inside the preset's clamp, as in family_b_train
    score_clips = np.stack([eval_loader.dataset[i][0]
                            for i in range(ATTN_SCORE_CLIPS)])
    n_normal = int((train_loader.dataset.labels == 0).sum())

    reset_counts()
    t0 = time.perf_counter()
    full = Trainer(cfg, out_dir=str(workdir / "attn_full"))
    hist = full.fit(train_loader, eval_loader)
    fit_s = time.perf_counter() - t0
    first = Trainer(cfg.replace(train=cfg.train.replace(
        num_epochs=TRAIN_EPOCHS - 1)), out_dir=str(workdir / "attn_resumed"))
    first.fit(train_loader, eval_loader)
    resumed = Trainer(cfg, out_dir=str(workdir / "attn_resumed"))
    restored = resumed.restore()
    resumed.fit(train_loader, eval_loader)
    best = full.ckpt.path("best")
    scores = make_family_b_score_fn(load_torch_state_dict(str(best)),
                                    cfg=cfg.model)(score_clips)
    ref = Trainer(cfg, out_dir=str(workdir / "attn_ref"))
    ref.init_state()
    ref.state.load_state_dict(full.ckpt.restore("best"))
    want = ref.task.eval_step(ref.state, ref.put_batch(
        {"clips": score_clips,
         "labels": np.zeros(len(score_clips), np.float32)}))
    torch.cuda.synchronize()
    launches = counts()

    steps = (2 * TRAIN_EPOCHS) * (ATTN_TRAIN_CLIPS // ATTN_BATCH)
    err = float(np.abs(scores - want["predictions"].cpu().numpy()).max())
    a, b = full.ckpt.restore(TRAIN_EPOCHS), resumed.ckpt.restore(TRAIN_EPOCHS)
    ckpt_same = all(torch.equal(v, b[part][k]) for part in
                    ("model_state_dict", "optimizer")
                    for k, v in a[part].items())
    bit_identical = same_run(full, resumed) and ckpt_same
    bank = a["model_state_dict"]
    n_params = param_count(full.state.model)
    evals = hist["evaluation_metrics"]
    emit({"phase": "attn_train", "params": n_params, "batch": ATTN_BATCH,
          "clip": list(ATTN_CLIP), "train_clips": ATTN_TRAIN_CLIPS,
          "normal_train_clips": n_normal,
          "eval_clips": len(eval_loader.dataset), "epochs": TRAIN_EPOCHS,
          "train_steps": steps, "launches": launches,
          "synthetic_data_s": data_s, "fit_s": fit_s,
          "train_losses": hist["train_losses"],
          "val_loss": [e["val_loss"] for e in evals],
          "auc": [e["auc"] for e in evals], "best_val_loss": full._best,
          "bank": list(bank["normal_memory"].shape),
          "bank_after_epoch_3": {"ptr": int(bank["memory_ptr"]),
                                 "fill": int(bank["memory_fill"])},
          "resumed_from_epoch": restored,
          "resume_bit_identical": bit_identical,
          "best_checkpoint_score_err": err,
          "best_score_mean": float(scores.mean())})
    check(n_params == ATTN_PARAMS, f"{n_params} parameters, not the flash "
                                   f"configuration's {ATTN_PARAMS:,}")
    check(tuple(bank["normal_memory"].shape) == (500, 128),
          f"bank {tuple(bank['normal_memory'].shape)}, not (500, 128)")
    check(len(hist["epochs"]) == TRAIN_EPOCHS
          and all(np.isfinite(hist["train_losses"]))
          and all(np.isfinite(e["val_loss"]) for e in evals),
          "attention train history")
    check(full._best == min(e["val_loss"] for e in evals),
          "best checkpoint is not the least val_loss")
    written = TRAIN_EPOCHS * n_normal
    check(int(bank["memory_fill"]) == min(written, 500)
          and int(bank["memory_ptr"]) == written % 500,
          f"bank after {TRAIN_EPOCHS} epochs: {bank['memory_ptr']}, "
          f"{bank['memory_fill']}")
    check(restored == TRAIN_EPOCHS - 1, f"restored epoch {restored}")
    check(bit_identical,
          "the resumed attention run differs from the uninterrupted one")
    check(scores.shape == (len(score_clips),)
          and bool(np.isfinite(scores).all()), "best checkpoint scores")
    check(err <= 1e-5, f"best checkpoint scorer vs eval step: {err}")
    layers = cfg.model.attn_layers
    check(launches["flash_dq"] == launches["flash_dkv"] == steps * layers
          and launches["flash_forward"] > steps * layers
          and launches["memory_min_cosine"] >= 1
          and launches["tfold_conv1"] == launches["s2d_group_forward"] == 0,
          f"main path 6 launches {launches} for {steps} train steps")
    return launches


def memory_times(rng: np.random.Generator) -> list:
    """K3 at MEM_SHAPES, MEM_WIDE and MEM_ATTN with a full bank: the kernel,
    the plain version, and the library yardstick F.normalize + torch.mm +
    torch.where + amin (which the port never calls), by CUDA events (`ms`)
    and, for the kernel and the library, on the card alone (`device_ms`,
    `library_device_ms`: calls queued behind a spin kernel, since both are
    host-bound at the small shapes), with the plan each launch took (tile,
    split of D, grid of the tiles kernel) and the bound from this call's
    bytes (each input read once, the output written once) and operations
    (2 B fill D at the float32 rate)."""
    import torch.nn.functional as F

    from cvad_tpu_torch.ops.pallas_kernels import (
        MEM_TILES, _launch_memory, memory_min_cosine_distance_reference,
        memory_plan)
    from cvad_tpu_torch.runtime.device import sm_count

    def library(q, mem, f):
        sims = torch.mm(F.normalize(q, dim=1, eps=1e-8),
                        F.normalize(mem, dim=1, eps=1e-8).T)
        col = torch.arange(mem.shape[0], device=q.device)
        dist = torch.where(col[None, :] < f, 1.0 - sims.clamp(-1.0, 1.0),
                           3.0)
        return dist.amin(dim=1).clamp(0.0, 2.0) / 2.0

    sms = sm_count(torch.device("cuda", 0))
    out = []
    for b, m, d in MEM_SHAPES + MEM_WIDE + (MEM_ATTN,):
        q, mem = memory_inputs(rng, b, m, d)
        f = torch.tensor(m, dtype=torch.int32, device="cuda")
        err = (library(q, mem, f) - _launch_memory(q, mem, f)).abs().max()
        plan = memory_plan(b, m, d, sms)

        def kernel():
            return _launch_memory(q, mem, f)

        t = {"B": b, "M": m, "D": d, "fill": m,
             "ms": cuda_ms(kernel, iters=200),
             "device_ms": device_ms(kernel, iters=200),
             "plain_ms": cuda_ms(lambda: memory_min_cosine_distance_reference(
                 q, mem, f), iters=50),
             "library_ms": cuda_ms(lambda: library(q, mem, f), iters=50),
             "library_device_ms": device_ms(lambda: library(q, mem, f),
                                            iters=50),
             "library_max_abs_diff": err.item(),
             "plan": {"tile": MEM_TILES[plan.tile], "splits": plan.splits,
                      "chunk": plan.chunk, "grid": plan.grid},
             **bound(((b + m) * d + b + 1) * 4, 2 * b * m * d,
                     PEAK_FLOPS[torch.float32])}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t["device_share_of_bound"] = t["bound_ms"] / t["device_ms"]
        out.append(t)
    return out


def kernel_times(rng: np.random.Generator, dtype: torch.dtype) -> dict:
    """tfold_conv1 at K1_TIMES (B, T) on 64x64 clips: the kernel and the
    library conv F.conv3d (which the port never calls), by CUDA events and
    on the card alone, each with its bound from this call's bytes and
    operations (81 MACs an output element); the plain version at the bulk
    shape (B=256, T=8) only, whose row is returned at the top level."""
    import torch.nn.functional as F

    from cvad_tpu_torch.ops.pallas_conv import (k1_rows, tfold_conv1,
                                                tfold_conv1_reference)
    from cvad_tpu_torch.runtime.device import sm_count

    # the bulk shape's inputs from `rng`, as before the other shapes were
    # added (so that every later phase's data stays as it was); theirs
    # from a generator of their own
    x_bulk = torch.from_numpy(rng.uniform(0, 1, (BULK_BATCH, 3) + CLIP[:3])
                              .astype(np.float32)).cuda().to(dtype)
    w = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                         .astype(np.float32)).cuda().to(dtype)
    gen = torch.Generator("cuda").manual_seed(LATER_CHECKS_SEED + 6)
    sms = sm_count(torch.device("cuda", 0))
    shapes = []
    for b, t in K1_TIMES:
        x = x_bulk if (b, t) == (BULK_BATCH, CLIP[0]) else torch.rand(
            (b, 3, t) + CLIP[1:3], generator=gen, device="cuda").to(dtype)
        y = tfold_conv1(x, w)
        iters = 50 if b * t <= BULK_BATCH * CLIP[0] else 20

        def kernel():
            return tfold_conv1(x, w)

        def library():
            return F.conv3d(x, w, stride=(1, 2, 2), padding=1)

        with no_tf32():
            r = {"B": b, "T": t, "rows": k1_rows(b, t, *CLIP[1:3], sms),
                 "ms": cuda_ms(kernel, iters),
                 "device_ms": device_ms(kernel, iters),
                 "library_ms": cuda_ms(library, iters),
                 "library_device_ms": device_ms(library, iters),
                 **bound((x.numel() + w.numel() + y.numel())
                         * x.element_size(), 2 * 3 * 27 * y.numel(),
                         PEAK_FLOPS[dtype])}
            if (b, t) == (BULK_BATCH, CLIP[0]):
                r["plain_ms"] = cuda_ms(lambda: tfold_conv1_reference(x, w),
                                        iters=10)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["device_share_of_bound"] = r["bound_ms"] / r["device_ms"]
        shapes.append(r)
        del x, y
    del x_bulk
    main = next(r for r in shapes if (r["B"], r["T"]) == (BULK_BATCH,
                                                          CLIP[0]))
    torch.cuda.empty_cache()
    return {"dtype": str(dtype).replace("torch.", ""), **main,
            "shapes": shapes}


def s2d_times(rng: np.random.Generator) -> dict:
    """K5 (forward, weight gradient) and K4 (forward, input and weight
    gradient) at the main path's shape, B=128, T=64, 64x64 (K5's input
    (128, 33, 33, 1024), K4's (1024, 33, 33, 120)), float32 and bfloat16:
    kernel, plain version and one library call (grouped `F.conv2d` on the
    channels-last view, or its `aten.convolution_backward`; TF32 off), with
    the bound from this call's bytes (each input read once, each output
    written once) and operations at the type's rate: the MACs each kernel
    does, K5's band (4 taps x 12C rows an output element, 38.7 GFLOP at
    this shape), K4's dense fold (pad channels and banded zeros included);
    `conv_bound_ms` counts only the conv's own 81 MACs an output.  Beside them: K1 and
    `F.conv3d` on the same conv, and the two layout copies around K5 in the
    model (the fold of the NCTHW input into slabs, and the unfold of K5's
    t-major output back to NCTHW), in float32."""
    import torch.nn.functional as F

    from cvad_tpu_torch.ops import pallas_s2d as ps
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1

    b, (t, h, w, c), g = LONG_BATCH, LONG_CLIP, LONG_G
    x = torch.from_numpy(rng.uniform(0, 1, (b, c, t, h, w))
                         .astype(np.float32)).cuda()
    w1 = torch.from_numpy(rng.normal(0, 0.2, (16, c, 3, 3, 3))
                          .astype(np.float32)).cuda()
    out = {"B": b, "T": t, "g": g}
    def fold():  # as TFoldConv1 folds its NCTHW input
        return ps.s2d_fold_groups(x.permute(0, 2, 3, 4, 1), g)

    def unfold():  # and unfolds K5's t-major output
        return y.view(b, h // 2, w // 2, t, 16).permute(
            0, 4, 3, 1, 2).contiguous()

    with no_tf32():
        y = ps.s2d_group_conv(fold(), ps.s2d_fold_kernel(
            w1.permute(2, 3, 4, 1, 0), g), g)
        out["layout_copies_f32"] = {
            "fold_ms": cuda_ms(fold, iters=10),
            "fold_bytes": (x.numel() + fold().numel()) * 4,
            "unfold_ms": cuda_ms(unfold, iters=10),
            "unfold_bytes": 2 * y.numel() * 4}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        d = s2d_inputs(rng, b, t, h, w, g, dtype)
        size, peak = d["xg"].element_size(), PEAK_FLOPS[dtype]
        xg, wdp, n, ct5 = d["xg"], d["wdp"], d["n"], d["ct5"]
        kp, no = wdp.shape[1], wdp.shape[2]
        w_lib = wdp.view(2, 2, kp, no).permute(3, 2, 0, 1).repeat(n, 1, 1, 1)
        x_lib, c_lib = xg.permute(0, 3, 1, 2), ct5.permute(0, 3, 1, 2)
        # K5 computes the band only: 4 taps x 12C rows an output element
        flops5 = 2 * ct5.numel() * 4 * 12 * c
        xf, wd, w4, ct4 = d["xf"], d["wd"], d["w4"], d["ct4"]
        kc = wd.shape[2]
        xf_lib, c4_lib = xf.permute(0, 3, 1, 2), ct4.permute(0, 3, 1, 2)
        wd_lib = wd.permute(3, 2, 0, 1)
        flops4 = 2 * ct4.numel() * 4 * kc
        x1, k1 = x.to(dtype), w1.to(dtype)

        def conv_bwd(gy, inp, wt, groups, needs):
            return torch.ops.aten.convolution_backward(
                gy, inp, wt, None, [1, 1], [0, 0], [1, 1], False, [0, 0],
                groups, [needs[0], needs[1], False])

        with no_tf32():
            rows = {
                "k5_forward": {
                    "ms": cuda_ms(lambda: ps._launch_group_forward(
                        xg, wdp, g, c, 16), 10),
                    "plain_ms": cuda_ms(lambda: ps._xla_slabs_core(
                        xg, wdp, n), 3),
                    "library_ms": cuda_ms(lambda: F.conv2d(
                        x_lib, w_lib, groups=n), 5),
                    **bound((xg.numel() + wdp.numel() + ct5.numel()) * size,
                            flops5, peak)},
                "k5_wgrad": {
                    "ms": cuda_ms(lambda: ps._launch_group_wgrad(
                        xg, ct5, g, c, 16, kp), 10),
                    "plain_ms": cuda_ms(lambda: ps.s2d_group_wgrad_reference(
                        xg, ct5, kp), 3),
                    "library_ms": cuda_ms(lambda: conv_bwd(
                        c_lib, x_lib, w_lib, n, (False, True)), 5),
                    **bound((xg.numel() + ct5.numel()) * size
                            + wdp.numel() * 4, flops5, peak)},
                "k4_forward": {
                    "ms": cuda_ms(lambda: ps._launch_forward(xf, w4), 10),
                    "plain_ms": cuda_ms(lambda: ps._xla_dot_core(xf, wd), 3),
                    "library_ms": cuda_ms(lambda: F.conv2d(xf_lib, wd_lib),
                                          5),
                    **bound((xf.numel() + wd.numel() + ct4.numel()) * size,
                            flops4, peak)},
                "k4_dgrad": {
                    "ms": cuda_ms(lambda: ps._launch_dgrad(ct4, w4), 10),
                    "plain_ms": cuda_ms(lambda: ps.s2d_matmul_dgrad_reference(
                        ct4, wd), 3),
                    "library_ms": cuda_ms(lambda: conv_bwd(
                        c4_lib, xf_lib, wd_lib, 1, (True, False)), 5),
                    **bound((ct4.numel() + wd.numel() + xf.numel()) * size,
                            flops4, peak)},
                "k4_wgrad": {
                    "ms": cuda_ms(lambda: ps._launch_wgrad(xf, ct4), 10),
                    "plain_ms": cuda_ms(lambda: ps.s2d_matmul_wgrad_reference(
                        xf, ct4), 3),
                    "library_ms": cuda_ms(lambda: conv_bwd(
                        c4_lib, xf_lib, wd_lib, 1, (False, True)), 5),
                    **bound((xf.numel() + ct4.numel()) * size
                            + wd.numel() * 4, flops4, peak)},
                "k1_same_conv": {
                    "ms": cuda_ms(lambda: tfold_conv1(x1, k1), 10),
                    "library_ms": cuda_ms(lambda: F.conv3d(
                        x1, k1, stride=(1, 2, 2), padding=1), 5),
                    **bound((x1.numel() + k1.numel() + ct5.numel()) * size,
                            2 * 81 * ct5.numel(), peak)}}
        # the conv's own work, without the fold's pad channels and banded
        # zeros: 81 MACs (C x 27 taps) an output element, as K1's bound
        conv_ops = 2 * 81 * ct5.numel()
        route = ps.k4_route(kc, wd.shape[3], xf.shape[2], dtype)
        for key, r in rows.items():
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            if key.startswith("k4_"):
                r["route"] = route
            if key != "k1_same_conv":
                conv = bound(r["bytes"], conv_ops, peak)["bound_ms"]
                r["conv_bound_ms"] = conv
                r["conv_share_of_bound"] = conv / r["ms"]
        out[name] = rows
        del d, xg, wdp, ct5, xf, wd, w4, ct4, x_lib, c_lib, xf_lib, c4_lib
        torch.cuda.empty_cache()
    return out


def flash_times(rng: np.random.Generator) -> list:
    """K6 at FLASH_TIMES, not causal (as the model runs it), float32 and
    bfloat16: the forward, dQ and dK/dV kernels alone, the plain version and
    the library yardstick `F.scaled_dot_product_attention`, which the port
    never calls; each timed with CUDA events around back-to-back calls
    (`ms`) and on the card alone (`device_ms`: the calls queued behind a
    spin kernel, so no host gap between launches is timed).  For the gradients the plain version's and
    the library's graphs are built once, outside the timed calls, so that
    only their backward is timed (autograd for the kernel's gradients, the
    graph kept).  The library's backward is one kernel that gives dQ, dK
    and dV whichever are asked for, so its time stands against K6's two
    kernels together (`backward_ms`, `library_backward_ms`).  Bounds from
    this call's bytes (each input read once, each output written once) and
    operations: the forward's two products, 4 B H T^2 Dh; the dQ kernel's
    three (QK^T recomputed, dO V^T, dS K), 6 B H T^2 Dh; the dK/dV kernel's
    four (QK^T and dO V^T recomputed, P^T dO, dS^T Q), 8 B H T^2 Dh; the
    backward as a whole needs at least 10 B H T^2 Dh
    (`backward_bound_ms`).  float32 products run as 3xTF32 on the tensor
    cores, so the f32 bounds take that rate (TF32X3_FLOPS) and keep the
    CUDA cores' beside them (`cuda_core_bound_ms`); bf16 takes the bf16
    rate.  `library_kernels` names the kernels SDPA ran (the profiler's
    busiest), which says which of its backends it took."""
    import torch.nn.functional as F

    from cvad_tpu_torch.ops import flash_attention as fa

    out = []
    for shape in FLASH_TIMES:
        b, h, t, dh = shape
        scale = dh ** -0.5
        mm = 2 * b * h * t * t * dh  # one (T x Dh) x (Dh x T) product
        for dtype in (torch.float32, torch.bfloat16):
            size, peak = dtype.itemsize, PEAK_FLOPS[dtype]
            tc_peak = TF32X3_FLOPS if dtype == torch.float32 else peak
            q, k, v, do = flash_inputs(rng, shape, dtype)
            o, lse = fa._launch_forward(q, k, v, False, scale)
            dq, dvec = fa._launch_dq(q, k, v, o, lse, do, False, scale)
            n = q.numel()
            rows = b * h * t * 4  # one float32 per row (lse, D)

            def plain(*xs):
                return fa.attention_reference(*xs, sm_scale=scale)

            def library(*xs):
                return F.scaled_dot_product_attention(*xs, scale=scale)

            def backward_of(attend, wrt):
                xs = [x.detach().requires_grad_(i in wrt)
                      for i, x in enumerate((q, k, v))]
                y = attend(*xs)
                want = [xs[i] for i in wrt]
                return lambda: torch.autograd.grad(y, want, do,
                                                   retain_graph=True)

            def bounds(nbytes: float, ops: float) -> dict:
                """The bound at the kernel's product rate (float32: 3xTF32
                on the tensor cores) and, beside it, at the CUDA cores'."""
                b = bound(nbytes, ops, tc_peak)
                return b | {"cuda_core_bound_ms":
                            bound(nbytes, ops, peak)["bound_ms"]}

            calls = {
                "forward": (
                    lambda: fa._launch_forward(q, k, v, False, scale),
                    lambda: plain(q, k, v), lambda: library(q, k, v),
                    bounds(4 * n * size + rows, 2 * mm)),
                "dq": (
                    lambda: fa._launch_dq(q, k, v, o, lse, do, False, scale),
                    backward_of(plain, (0,)), backward_of(library, (0,)),
                    bounds(6 * n * size + 2 * rows, 3 * mm)),
                "dkv": (
                    lambda: fa._launch_dkv(q, k, v, do, lse, dvec, False,
                                           scale),
                    backward_of(plain, (1, 2)), backward_of(library, (1, 2)),
                    bounds(6 * n * size + 2 * rows, 4 * mm))}
            iters = 50 if t <= 128 else 5
            row = {"shape": list(shape),
                   "dtype": str(dtype).replace("torch.", "")}
            for part, (kernel, plain_fn, library_fn, bnd) in calls.items():
                r = {"ms": cuda_ms(kernel, iters),
                     "device_ms": device_ms(kernel, iters),
                     "plain_ms": cuda_ms(plain_fn, iters),
                     "plain_device_ms": device_ms(plain_fn, iters),
                     "library_ms": cuda_ms(library_fn, iters),
                     "library_device_ms": device_ms(library_fn, iters),
                     **bnd}
                r["share_of_bound"] = r["bound_ms"] / r["ms"]
                r["device_share_of_bound"] = r["bound_ms"] / r["device_ms"]
                row[part] = r
            whole = bounds(8 * n * size + rows, 5 * mm)
            row["backward_bound_ms"] = whole["bound_ms"]
            row["backward_cuda_core_bound_ms"] = whole["cuda_core_bound_ms"]
            for key in ("ms", "device_ms"):
                row[f"backward_{key}"] = row["dq"][key] + row["dkv"][key]
            library_bwd = backward_of(library, (0, 1, 2))
            row["library_backward_ms"] = cuda_ms(library_bwd, iters)
            row["library_backward_device_ms"] = device_ms(library_bwd, iters)
            row["library_kernels"] = {
                "forward": kernel_names(lambda: library(q, k, v)),
                "backward": kernel_names(library_bwd)}
            out.append(row)
            del q, k, v, do, o, lse, dq, dvec, calls, library_bwd
    torch.cuda.empty_cache()
    return out


def kernel_names(fn) -> list:
    """The names of the CUDA kernels one call of `fn` runs (warm), busiest
    first, from torch.profiler tracing the card alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return [key[:100] for _, key in rows]


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time for `nbytes` moved and `ops` done at `peak`
    operations/s, and which of the two bounds it."""
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def pairwise_times(rng: np.random.Generator, b: int = 256,
                   n: int = 256) -> dict:
    """K2 forward and backward at (B, N) (the main path's 256 x 256 by
    default) with a mask at the main path's rate: kernels, plain versions,
    and torch.cdist(p=1) (the library call for the pairwise L1 matrix,
    which the port never calls) with its backward.  Simple operations
    (sub, abs or sign, add) count one each at the float32 rate."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        _launch_backward, _launch_forward, pairwise_backward_plan,
        pairwise_l1_backward_reference, pairwise_l1_reference)
    from cvad_tpu_torch.runtime.device import sm_count

    iters = 200 if n <= 256 else 20
    flat, m = pair_inputs(rng, b, n, "random")
    ct = torch.ones((), device="cuda")
    avg, n_pairs = _launch_forward(flat, m)
    s = float(m.sum())
    pairs = float(n_pairs)
    fwd = {"ms": cuda_ms(lambda: _launch_forward(flat, m), iters=iters),
           "plain_ms": cuda_ms(lambda: pairwise_l1_reference(flat, m),
                               iters=20),
           "library_ms": cuda_ms(lambda: torch.cdist(flat, flat, p=1),
                                 iters=iters),
           **bound((b * n + b + 2) * 4, 3 * pairs * n,
                   PEAK_FLOPS[torch.float32])}
    fr = flat.clone().requires_grad_(True)
    w = torch.triu(m[:, None] * m[None, :], 1)
    lib_loss = (torch.cdist(fr, fr, p=1) * w).sum()
    bwd = {"ms": cuda_ms(lambda: _launch_backward(flat, m, n_pairs, ct),
                         iters=iters),
           "plain_ms": cuda_ms(lambda: pairwise_l1_backward_reference(
               flat, m, n_pairs, ct), iters=20),
           "library_ms": cuda_ms(lambda: torch.autograd.grad(
               lib_loss, fr, retain_graph=True), iters=50),
           **bound((2 * b * n + b + 2) * 4, 3 * s * s * n,
                   PEAK_FLOPS[torch.float32])}
    # the card's time alone beside the events, which over these short
    # launches time the host as much as the card
    fwd["device_ms"] = device_ms(lambda: _launch_forward(flat, m), iters)
    fwd["library_device_ms"] = device_ms(
        lambda: torch.cdist(flat, flat, p=1), iters)
    bwd["device_ms"] = device_ms(
        lambda: _launch_backward(flat, m, n_pairs, ct), iters)
    bwd["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
        lib_loss, fr, retain_graph=True), 50)
    for t in (fwd, bwd):
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t["device_share_of_bound"] = t["bound_ms"] / t["device_ms"]
    bwd["plan"] = pairwise_backward_plan(
        b, n, sm_count(flat.device))._asdict()
    return {"B": b, "N": n, "mask_rows": s, "n_pairs": pairs,
            "forward": fwd, "backward": bwd}


def tfold_backward_times(rng: np.random.Generator) -> dict:
    """K1's backward through the plain version (the folded conv's backward)
    at B=256, under the train step's cuDNN settings: the weight gradient
    alone, as on the main path, where the clips need none, and with the
    input gradient.  The library call is the unfolded Conv3d's backward
    (`aten.convolution_backward`, what F.conv3d's autograd runs)."""
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1_backward_reference
    from cvad_tpu_torch.train.tasks import card_numerics

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.uniform(0, 1, (BULK_BATCH, 3) + CLIP[:3])
                             .astype(np.float32)).cuda().to(dtype)
        w = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                             .astype(np.float32)).cuda().to(dtype)
        g = torch.randn((BULK_BATCH, 16, 8, 32, 32), device="cuda").to(dtype)

        def library(needs):
            return torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 2, 2], [1, 1, 1], [1, 1, 1], False,
                [0, 0, 0], 1, [needs[0], needs[1], False])

        with card_numerics():
            out[str(dtype).replace("torch.", "")] = {
                "weight_grad_ms": cuda_ms(
                    lambda: tfold_conv1_backward_reference(
                        g, x, w, (False, True)), iters=20),
                "x_and_weight_grad_ms": cuda_ms(
                    lambda: tfold_conv1_backward_reference(g, x, w),
                    iters=20),
                "library_weight_grad_ms": cuda_ms(
                    lambda: library((False, True)), iters=5),
                "library_x_and_weight_grad_ms": cuda_ms(
                    lambda: library((True, True)), iters=5)}
    return out


def train_step_times(rng: np.random.Generator, dtype: str,
                     family: str = "d") -> dict:
    """The train step of family D (or B) at B=256 from uint8 clips already
    on the card: CUDA events around each of 20 steps after 3 warm-up
    steps.  Family B's labels are normal at the train split's rate.
    family='d64' is the long-window step: T=64, B=128, conv1 on K5;
    'd64_k1' the same step with the default lowering, conv1 on K1 (its
    backward the whole-T folded conv's); 'b_attn' family B with the
    attention encoder at B=16, T=128 (attention on K6, in float32 at
    either dtype, as in `cvad_tpu`)."""
    from cvad_tpu_torch.train.tasks import build_task

    batch_size = TRAIN_BATCH
    if family == "b":
        cfg, clip = b_train_config(TRAIN_BATCH, dtype=dtype), CLIP_B
    elif family == "b_attn":
        batch_size, clip = ATTN_BATCH, ATTN_CLIP
        cfg = attn_config(ATTN_BATCH, dtype=dtype)
    elif family in ("d64", "d64_k1"):
        batch_size, clip = LONG_BATCH, LONG_CLIP
        cfg = long_config(LONG_BATCH, dtype=dtype)
        if family == "d64_k1":
            cfg = cfg.replace(model=cfg.model.replace(conv_group_impl="stack"))
    else:
        cfg, clip = train_config(TRAIN_BATCH, dtype=dtype), CLIP
    t0 = time.perf_counter()
    task = build_task(cfg)
    state = task.init_state(0, "cuda")
    batch = {"clips": torch.from_numpy(rng.integers(
        0, 256, (batch_size,) + clip, dtype=np.uint8)).cuda(),
        "labels": torch.from_numpy((rng.uniform(size=batch_size)
                                    < B_ANOMALY_RATE).astype(np.float32))
        .cuda()}

    def step():
        nonlocal state
        state, _ = task.train_step(state, batch, 1)

    for _ in range(3):
        step()
    ms = []
    for _ in range(20):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step()
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    med = statistics.median(ms)
    return {"family": family, "dtype": dtype, "B": batch_size,
            "T": clip[0], "steps": len(ms),
            "median_ms": med, "min_ms": min(ms), "max_ms": max(ms),
            "clips_per_s": batch_size / med * 1e3,
            "breakdown": device_breakdown(step),
            "seconds": time.perf_counter() - t0}


def device_breakdown(fn) -> dict:
    """Device time by kernel over one call of `fn` (warm), from
    torch.profiler; busy share = summed device time over the call's wall
    time (the call ends in a synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    return {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top": [{"name": k[:80], "ms": t / 1e3, "calls": c}
                    for k, t, c in rows[:12]],
            "port_kernels": [{"name": k[:80], "ms": t / 1e3, "calls": c}
                             for k, t, c in rows
                             if any(n in k for n in PORT_KERNELS)]}


def forward_breakdown(score, clips: np.ndarray) -> dict:
    """Device time by kernel over one scorer call (host copy in, forward,
    copy out)."""
    return {"clips": len(clips), **device_breakdown(lambda: score(clips))}


def request_latency(base: str, rng: np.random.Generator, n: int = 30,
                    clip: tuple = CLIP) -> list:
    """Closed loop, one client: `n` float32 npz requests of each bucket's
    size, timed from send to parsed reply.  ``score_ms`` is the batching
    worker's host-clock time in the service (forward and copies, ending in
    the device-to-host copy), from /stats; the rest is HTTP, npz and JSON."""
    out = []
    for b in BUCKETS:
        body = npz(rng.uniform(0, 1, (b,) + clip).astype(np.float32))
        post(base + "/score", body, "application/octet-stream")
        score_s0 = get(base + "/stats")["score_seconds_total"]
        lat = []
        for _ in range(n):
            t0 = time.perf_counter()
            rep = post(base + "/score?graphs=0", body,
                       "application/octet-stream")
            lat.append((time.perf_counter() - t0) * 1e3)
            check(rep["n"] == b, "latency request answered")
        score_s = get(base + "/stats")["score_seconds_total"] - score_s0
        lat.sort()
        out.append({"bucket": b, "requests": n, "dtype": "float32",
                    "p50_ms": statistics.median(lat),
                    "p90_ms": lat[int(0.9 * (n - 1))], "max_ms": lat[-1],
                    "score_ms_mean": score_s / n * 1e3})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    from cvad_tpu_torch.evaluation.scoring import (make_family_b_score_fn,
                                                   make_family_d_score_fn)
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    errs = phase_kernels(rng)

    state = load_torch_state_dict(str(CKPT))
    phase_model(state, rng.uniform(0, 1, (128,) + CLIP).astype(np.float32))

    # inputs of main path 1, and the direct float32 scorer's answers to
    # them, made before the launch counts are reset
    requests = [rng.uniform(0, 1, (n,) + CLIP).astype(np.float32)
                for n in (1, 5, 32)]
    requests.append(rng.integers(0, 256, (8,) + CLIP, dtype=np.uint8))
    bulk_clips = rng.integers(0, 256, (BULK_CLIPS,) + CLIP, dtype=np.uint8)
    direct = make_family_d_score_fn(state)
    direct_scores = [direct(c)[0] for c in requests]
    bulk_ref = np.concatenate([direct(bulk_clips[i:i + BULK_BATCH])[0]
                               for i in range(0, BULK_CLIPS, BULK_BATCH)])

    reset_counts()
    srv, base = phase_serve(requests, direct_scores)
    try:
        bulk = phase_bulk(state, bulk_clips, bulk_ref)
        serve_launches = counts()
        emit({"phase": "main_path", "path": "serve", "launches":
              serve_launches})
        check(serve_launches["tfold_conv1"] > 0,
              "the serving path never launched tfold_conv1")

        times32 = kernel_times(rng, torch.float32)
        times16 = kernel_times(rng, torch.bfloat16)
        latency = request_latency(base, rng)
    finally:
        srv.close()
    bulk_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        bulk(bulk_clips)
        bulk_s.append(time.perf_counter() - t0)
    breakdown = {
        "f32_bucket128": forward_breakdown(direct, requests[2].repeat(4, 0)),
        "bf16_bulk_chunk": forward_breakdown(bulk, bulk_clips[:BULK_BATCH])}

    phase_train_parity(state, rng)
    phase_family_b_model(rng)
    phase_family_b_parity(rng)
    paths = {"serve": serve_launches}
    # main path 5, scoring: the fixture on 64-frame clips, both routes
    long_clips = rng.uniform(0, 1, (LONG_BATCH,) + LONG_CLIP).astype(
        np.float32)
    paths["long_score"] = phase_long_model(state, long_clips)  # resets
    emit({"phase": "main_path", "path": "long_score",
          "launches": paths["long_score"]})
    del long_clips
    # long_train_parity draws from its own generator; the shared stream
    # still advances past what the phase drew from it before, so that
    # every later phase keeps its data
    long_parity_data(rng)
    phase_long_train_parity()
    with tempfile.TemporaryDirectory(prefix="cvad_chip_smoke_") as tmp:
        # main path 5, training (resets the counts first)
        paths["long_train"] = phase_long_train(Path(tmp))
        emit({"phase": "main_path", "path": "long_train",
              "launches": paths["long_train"]})
        paths["train"] = phase_train(Path(tmp))  # resets the counts first
        emit({"phase": "main_path", "path": "train",
              "launches": paths["train"]})
        paths["family_b_train"], best_b = phase_family_b_train(Path(tmp))
        emit({"phase": "main_path", "path": "family_b_train",
              "launches": paths["family_b_train"]})

        # inputs of main path 4 and the direct scorer's answers to them,
        # made before the launch counts are reset
        requests_b = [rng.uniform(0, 1, (n,) + CLIP_B).astype(np.float32)
                      for n in (1, 5, 32)]
        requests_b.append(rng.integers(0, 256, (8,) + CLIP_B,
                                       dtype=np.uint8))
        direct_b = make_family_b_score_fn(load_torch_state_dict(str(best_b)))
        direct_b_scores = [direct_b(c) for c in requests_b]
        reset_counts()
        srv_b, base_b = phase_serve(requests_b, direct_b_scores, best_b,
                                    family="b", phase="family_b_serve")
        try:
            paths["family_b_serve"] = counts()
            emit({"phase": "main_path", "path": "family_b_serve",
                  "launches": paths["family_b_serve"]})
            check(paths["family_b_serve"]["memory_min_cosine"] >= 1,
                  "the family-B serving path never launched "
                  "memory_min_cosine")
            latency_b = request_latency(base_b, rng, clip=CLIP_B)
        finally:
            srv_b.close()
        breakdown["b_f32_bucket128"] = forward_breakdown(
            direct_b, requests_b[2].repeat(4, 0))

        # family B with the attention encoder on 128-frame clips
        phase_attn_model(rng)
        phase_attn_parity(rng)
        phase_widths(rng)
        paths["attn_train"] = phase_attn_train(Path(tmp))  # resets first
        emit({"phase": "main_path", "path": "attn_train",
              "launches": paths["attn_train"]})

    train_times = [train_step_times(rng, "float32"),
                   train_step_times(rng, "bfloat16"),
                   train_step_times(rng, "float32", "b"),
                   train_step_times(rng, "bfloat16", "b"),
                   train_step_times(rng, "float32", "d64"),
                   train_step_times(rng, "bfloat16", "d64"),
                   train_step_times(rng, "float32", "d64_k1"),
                   train_step_times(rng, "bfloat16", "d64_k1"),
                   train_step_times(rng, "float32", "b_attn"),
                   train_step_times(rng, "bfloat16", "b_attn")]
    spent = {}  # seconds of each timing block

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[name] = time.perf_counter() - t0
        return out

    s2d_t = timed("s2d", s2d_times, rng)
    pair_t = timed("pairwise_l1", pairwise_times, rng)
    pair_t["wide"] = timed("pairwise_l1_wide", pairwise_times, rng,
                           *PAIR_WIDE)
    pair_t["odd"] = timed("pairwise_l1_odd", pairwise_times,
                          np.random.default_rng(LATER_CHECKS_SEED + 2),
                          *PAIR_ODD)
    pair_t["t64"] = timed("pairwise_l1_t64", pairwise_times,
                          np.random.default_rng(LATER_CHECKS_SEED + 8),
                          *PAIR_T64)
    k1_bwd = timed("tfold_conv1_backward", tfold_backward_times, rng)
    mem_t = timed("memory_min_cosine", memory_times, rng)
    flash_t = timed("flash_attention", flash_times, rng)
    emit({"phase": "times", "card": dev["card"], "kernel": [times32, times16],
          "request_latency": latency, "request_latency_b": latency_b,
          "forward_breakdown": breakdown,
          "bulk": {"clips": BULK_CLIPS, "batch": BULK_BATCH,
                   "dtype": "bfloat16", "input": "uint8",
                   "seconds": bulk_s,
                   "clips_per_s": BULK_CLIPS / statistics.median(bulk_s)},
          "train_step": train_times, "pairwise_l1": pair_t,
          "tfold_conv1_backward_plain": k1_bwd, "memory_min_cosine": mem_t,
          "s2d": s2d_t, "flash_attention": flash_t, "seconds": spent,
          "total_s": time.perf_counter() - t_start})

    def row(t: dict, err: float) -> dict:
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")} | {"max_abs_err": err}

    def launches(name: str) -> dict:
        by_path = {p: c[name] for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    def s2d_entry(name: str, line: int, counter: str) -> dict:
        """K4 and K5 at the main shape (B=128, T=64): f32 times, the bf16
        ones beside them, the largest error of the kernels phase.
        `bound_ms` counts the MACs the kernel does (K5 the band of the
        fold, K4 the dense fold), `conv_bound_ms` only the conv's own.  K4
        is on no main path (no model calls it)."""
        part = counter.replace("s2d_group_", "k5_").replace(
            "s2d_matmul_", "k4_")
        err = {dt: errs["s2d"][f"{part}_{dt}"]
               for dt in ("float32", "bfloat16")}

        def s2d_row(dt: str) -> dict:
            t = s2d_t[dt][part]
            extra = {"conv_bound_ms": t["conv_bound_ms"]}
            if part.startswith("k4"):  # on dense weights too, and its route
                extra |= {"route_taken": t["route"],
                          "max_abs_err_dense":
                              errs["s2d"][f"{part}_dense_{dt}"]}
            return row(t, err[dt]) | extra

        source = "s2d_group_conv" if part.startswith("k5") else "s2d_conv"
        return {"name": name, "route": "cuda",
                "source": f"cvad_tpu_torch/csrc/{source}.cu",
                "replaces": f"cvad_tpu/ops/pallas_s2d.py:{line}",
                **launches(counter), "on_main_path": part.startswith("k5"),
                "dtype": "float32", "B": LONG_BATCH,
                "T": LONG_CLIP[0], **s2d_row("float32"),
                "bfloat16": s2d_row("bfloat16"), "card": dev["card"]}

    def mem_row(t: dict) -> dict:
        """A K3 row: the event times, the card's time alone beside them and
        the launch's plan."""
        return {k: t[k] for k in ("B", "M", "D")} | row(
            t, errs["memory"]) | {k: t[k] for k in (
                "device_ms", "library_device_ms", "plan")}

    def pair_row(t: dict, part: str, err: float) -> dict:
        """A K2 row: the event times, the card's time alone beside them,
        and the backward's plan."""
        return row(t[part], err) | {key: t[part][key] for key in (
            "device_ms", "library_device_ms", "plan") if key in t[part]}

    def flash_entry(name: str, line: int, part: str, counter: str) -> dict:
        """K6 at the main path's shape (B, H, T, Dh) = (16, 1, 128, 128):
        f32 times (the model's type; CUDA events, and the card's time
        alone beside them), bf16 beside them, the long window (8, 1, 2048,
        128) in `long`, head dim 256 (16, 1, 128, 256) in `head256`, the
        largest error of the kernels phase over this kernel's outputs."""
        def part_row(shape: tuple, dt: str) -> dict:
            t = next(r for r in flash_t if tuple(r["shape"]) == shape
                     and r["dtype"] == dt)
            outs = {"forward": ("forward",), "dq": ("dq",),
                    "dkv": ("dk", "dv")}[part]
            err = max(errs["flash"][f"{o}_{dt}"] for o in outs)
            return row(t[part], err) | {
                key: t[part][key] for key in (
                    "device_ms", "plain_device_ms", "library_device_ms",
                    "cuda_core_bound_ms")}

        main, long, wide = FLASH_TIMES
        return {"name": name, "route": "cuda",
                "source": "cvad_tpu_torch/csrc/flash_attention.cu",
                "replaces": "jax/experimental/pallas/ops/tpu/"
                            f"flash_attention.py:{line}",
                "called_from": "cvad_tpu/ops/attention.py:47-50",
                **launches(counter), "dtype": "float32",
                "shape": list(main), **part_row(main, "float32"),
                "bfloat16": part_row(main, "bfloat16"),
                "long": {"shape": list(long)}
                | part_row(long, "float32"),
                "head256": {"shape": list(wide)}
                | part_row(wide, "float32"), "card": dev["card"]}

    emit({"kernels": [
        {"name": "tfold_conv1", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/tfold_conv1.cu",
         "replaces": "cvad_tpu/ops/pallas_conv.py:178",
         **launches("tfold_conv1"),
         "dtype": "float32", "B": BULK_BATCH,
         **row(times32, errs["f32"]), "device_ms": times32["device_ms"],
         "bfloat16": row(times16, errs["bf16"])
         | {"device_ms": times16["device_ms"]},
         "shapes": {"float32": times32["shapes"],
                    "bfloat16": times16["shapes"]},
         "backward_plain_ms": k1_bwd, "card": dev["card"]},
        {"name": "pairwise_l1_forward", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/pairwise_l1.cu",
         "replaces": "cvad_tpu/ops/pallas_kernels.py:214",
         **launches("pairwise_l1_forward"),
         "dtype": "float32", "B": pair_t["B"], "N": pair_t["N"],
         **pair_row(pair_t, "forward", errs["pair_fwd"]),
         "wide": {"B": PAIR_WIDE[0], "N": PAIR_WIDE[1]}
         | pair_row(pair_t["wide"], "forward", errs["pair_fwd"]),
         "odd": {"B": PAIR_ODD[0], "N": PAIR_ODD[1]}
         | pair_row(pair_t["odd"], "forward", errs["pair_fwd"]),
         "card": dev["card"]},
        {"name": "pairwise_l1_backward", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/pairwise_l1.cu",
         "replaces": "cvad_tpu/ops/pallas_kernels.py:243",
         **launches("pairwise_l1_backward"),
         "dtype": "float32", "B": pair_t["B"], "N": pair_t["N"],
         **pair_row(pair_t, "backward", errs["pair_bwd"]),
         "wide": {"B": PAIR_WIDE[0], "N": PAIR_WIDE[1]}
         | pair_row(pair_t["wide"], "backward", errs["pair_bwd"]),
         "odd": {"B": PAIR_ODD[0], "N": PAIR_ODD[1]}
         | pair_row(pair_t["odd"], "backward", errs["pair_bwd"]),
         "t64": {"B": PAIR_T64[0], "N": PAIR_T64[1]}
         | pair_row(pair_t["t64"], "backward", errs["pair_bwd"]),
         "card": dev["card"]},
        {"name": "memory_min_cosine", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/memory_cosine.cu",
         "replaces": "cvad_tpu/ops/pallas_kernels.py:102",
         **launches("memory_min_cosine"),
         "dtype": "float32", **mem_row(mem_t[0]),
         "large": mem_row(mem_t[1]),
         "wide": [mem_row(t) for t in mem_t[2:4]],
         "attention": mem_row(mem_t[4]), "card": dev["card"]},
        *(s2d_entry(name, line, counter) for name, line, counter in (
            ("s2d_group_conv_forward", 418, "s2d_group_forward"),
            ("s2d_group_conv_wgrad", 468, "s2d_group_wgrad"),
            ("s2d_fold_matmul_forward", 177, "s2d_matmul_forward"),
            ("s2d_fold_matmul_dgrad", 223, "s2d_matmul_dgrad"),
            ("s2d_fold_matmul_wgrad", 271, "s2d_matmul_wgrad"))),
        flash_entry("flash_attention_forward", 758, "forward",
                    "flash_forward"),
        flash_entry("flash_attention_dkv", 1121, "dkv", "flash_dkv"),
        flash_entry("flash_attention_dq", 1456, "dq", "flash_dq")]})
    print(dev["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
