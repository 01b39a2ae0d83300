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
           CPU's own float32 gradient's (e_cpu), both float32 gradients
           taken with every ReLU's mask pinned to float64's (a ReLU
           decision that float32 rounding flips is not arithmetic); the
           flipped decisions of the unpinned float32 forwards, card and
           CPU, counted by layer, each within 1e-5 of its layer's largest
           |float64| pre-activation; each card step and gradient launches
           K5 forward and weight gradient and K2 forward and backward once
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
  video    (main path 7) frame-folder video end to end: the port's
           writer puts UCSD Ped2's test split at its layout and size in a
           temporary directory (12 videos of 180 gray 240x360 PGM frames
           with `_gt` mask folders, ~375 MB); the port's native decoder is
           its own build of native/decoder.cpp and must load (no zero-frame
           fallback), 8 frames decoded at their own size equal the written
           bytes bit for bit, and every clip scored has a nonzero maximum;
           VideoScorer + frame_level_auc over every video: video_score_d
           (the fixture, RGB 8x64x64 stride 4, 44 windows a video; K1
           only), video_score_b (seeded family B with 300 bank rows,
           memory_ae's data: gray, stride 2, 87 windows; K3 only),
           video_score_d64 (the fixture at clip_len 64, stride 16,
           conv_group_impl='s2d', 8 windows; K5's forward only), the
           counts set to 0 just before each path and read just after;
           stream_d replays one video frame by frame through
           StreamingScorer (B=1): windows equal the batched scorer's
           within 1e-5; the port on the CPU scores the first 2 videos of
           each path: windows and frames within 1e-4, per-video frame AUC
           within 1e-3; a line a path with windows, frames, seconds
           (decode apart from score), frames/s, windows/s, launches and
           the frame AUCs
  family_c  (main path 8) family C, the mini3d preset (8x64x64x1 clips,
           B=8): its scorer on the card against the CPU's from the same
           weights (within 1e-5); 3 float32 train steps card vs CPU step
           by step from the same init, dropout off: each step from the
           CPU run's train state before it, every ReLU's mask and max
           pool's argmax pinned to the CPU's float64 forward; on every
           leaf the card's gradient within 1e-4 + 4 e_cpu of float64's
           largest entry (e_cpu the CPU's own float32 error); after the step the metrics within rtol 1e-4,
           every parameter whose gradient lies above 1e-3 of its leaf's
           largest within 2e-5, every one within 2 lr, at most 0.1%
           beyond 2e-5, the running statistics within 1e-5 of each leaf's
           largest entry;
           `Trainer.fit` on synthetic clips (256 train, 64 eval, 2 epochs,
           eval (auc) and a checkpoint an epoch), a run of 1 epoch resumed
           and finished bit-identical to it; the best checkpoint's scorer
           within 1e-5 of the eval step; the step times (f32, bf16); no
           port kernel launched (cuDNN convs, as cvad_tpu runs XLA's)
  family_a  (main path 9) family A at full width, the causal_pipeline
           preset (16x240x360x1 clips, B=4, channels 32-256): the eval
           forward on the card against the CPU (scores, adjacency,
           detections within 1e-2 px, both masks equal, no box coordinate
           within 1e-2 px of a threshold), from the preset's
           initialisation and from a detector head whose boxes cross the
           thresholds by frame and slot; from such a head placed on the
           steps' batches, 3 float32 train steps card vs CPU (family_c's
           rule; dropout off, the VAE draws shared; every box 1e-2 px
           from a threshold at each step, the valid share strictly
           between 0 and 1);
           the bf16 step's loss within 2e-2 of the f32 step's; one step
           of causal_pipeline_v0 (loss = score MSE + 0.001 KL); 3 remat
           steps bit-identical to the plain ones (running statistics and
           Adam included); `Trainer.fit` (32 train, 16 eval clips, 2
           epochs, val_acc and the analysis), a resumed run bit-identical
           to it; the best checkpoint's scorer within 1e-5 of the eval
           step; the step times (f32, bf16, anchor); no port kernel
           launched
  video    (also) video_score_a: family A's best checkpoint from phase
           family_a scores the tree (16-frame windows at 240x360, stride 8,
           21 a video) with no port kernel launched, the CPU on 2 videos
  family_e  family E (bbox_viz) at its full default width (517,505
           parameters, seeded), through a reference-format .pth loaded
           with strict=True: 128 clips (8x64x64x3) on the card and on the
           CPU, TF32 off: scores and adjacency within 1e-5, features within
           1e-5 of their largest; a second card call bit-identical; then
           make_score_fn('e') through VideoScorer over phase video's tree
           (path video-e, every kernel count 0) and on the CPU over every
           video: windows within 1e-5, every per-video frame AUC equal
  report   `cli report` end to end (path report): the port's writer puts
           phase video's sizes in RGB PPM (12 videos of 180 240x360
           frames, ~560 MB) in a temporary directory; the CPU scores every
           window with the fixture, and the threshold keeps the top k
           (k >= 5) where no window lies within 1e-4 of it and no two kept
           within 2e-6; `report` with the fixture on the card (the counts
           set to 0 just before and read just after: K1 at least once a
           scored batch, every other 0) and on the CPU, detector 'auto'
           (offline: the motion detector): the same clip ids, videos,
           frame ranges, video distribution and backend ('motion'),
           scores within 1e-5, each clip's _info.json the same; the first
           clip's frames drawn by the numpy path with each run's score
           equal; the HTML holds a row a clip and links every file listed;
           whether matplotlib and cv2 are present and how many PNG, MP4
           and JSON files were written (no PNG without matplotlib, no MP4
           without cv2); the phase's seconds (tree, CPU pre-pass, each
           report) beside the card's name and power limit
  export   every family's scorer through `cli export` on the card from a
           reference-format .pth, then `load_scorer`: D (the fixture,
           8x64x64x3; K1), D at T=64 (the fixture, conv_group_impl='s2d';
           K5), B with the LSTM (seeded, 300 bank rows; K3), B with
           attention (bench.py's flash configuration, T=128; K6 forward
           and K3), C, A (16x240x360x1) and E (seeded); at buckets 1, 8
           and 32 (A 1 and 4) every output within 1e-5 of the eager scorer
           and its `ScorerModule` (TF32 off), uint8 clips at the first
           bucket, each kernel's launch count through the artefact equal
           to the eager scorer's on the same clips (paths
           export_<artefact>, the counts set to 0 just before), a second
           call bit-identical, export and load seconds and the buckets'
           median latencies beside the eager scorer's; a fresh process
           that imports only `cvad_tpu_torch.ops` loads the D and
           B-attention artefacts with `torch.export.load` and scores them
           (within 1e-5, no model module imported); one HTTP round trip
           each from the A and B-attention artefacts (A's detections as
           "graphs") within 1e-5; `cli serve D.pt2 --probe-timeout 120` in
           its own process: the device probe passes, /healthz gives the
           artefact's clip shape, one request within 1e-5
  steps_per_call  K train steps in one captured CUDA graph
           (`train/graphs.py`) on every train path at full width: d (T=8,
           B=256; K1, K2), d64 (T=64, B=128, conv1 on K5; K5, K2), b (LSTM,
           B=256), b_attn (T=128, B=16; K6), c (B=8), a (16x240x360, B=4)
           and a_remat: from one initial state, 8 eager float32 steps
           against 2 replays of a graph of 4 steps on the same 8 batches;
           every state-dict entry (parameters, BatchNorm statistics, family
           B's bank and fill), Adam's moments, count and lr, `step` and the
           summed metric vector bit-identical, and each kernel's launch
           count through the replays (main paths graph_<path>) equal to
           the eager steps'; `Trainer.fit` of family D (T=8, B=256, 1,536
           clips: a chunk of 4 and 2 single steps an epoch, 2 epochs, eval
           every epoch) with steps_per_call=4 and the device cache on (main
           path steps_per_call_fit), the cache on at K=1 and off at K=4,
           each bit-identical to steps_per_call=1 with the cache off
           (history and state), and a run that dies right after epoch 2's
           'mid' checkpoint at the chunk boundary, resumed bit-identically;
           the fit seconds and the cache's fill time and bytes; each
           path's step in f32 and bf16, eager and as graphs of 4 and 16
           steps: per-step median of 20 calls (CUDA events) and busy share
           (torch.profiler over one call)
  parallel (main path parallel) the multi-device layer on an NCCL process
           group of world size 1 (one card; NCCL takes one rank a card),
           started in this process from a file:// rendezvous and destroyed
           after: family D at full width (B=256, uint8 64x64 clips) through
           the mesh Trainer, 4 eager steps then one captured 4-step graph
           with NCCL's collectives inside it, and family B at memory_ae's
           width (B=64) one step and eval, each bit-identical to the same
           run with no process group (parameters, BatchNorm statistics,
           bank, both Adam moments, metric sums, predictions); the sharded
           scorers of D (the fixture) and C (seed 0) equal to the plain
           ones bit for bit on 64 clips; temporal_sharded_forward at time
           axis 1 on 16 clips of T=64 (conv1 on F.conv3d) within 1e-5 of
           the model's forward (K1); K1, K2 and K3 launched, the
           collectives' calls; the eager step time (median of 20, CUDA
           events) of the mesh trainer beside the plain one
  compat   (main path compat) the reference-API drivers of
           `cvad_tpu_torch.compat` on the card over an Avenue-layout tree
           the port's writer puts in a temporary directory (6 train and 2
           test videos of 40 RGB 64x64 PPM frames under training/frames
           and testing/frames): train_improved_minicausal_vad for 2
           epochs, then train_minicausal_vad_on_avenue and
           test_trained_model on the first one's best_improved_model.pth
           (family D at full width, T=8, batch 4; K1, K2 forward and
           backward counted); then ImprovedMiniCausalVAD from the fixture
           on the card and on the CPU, dropout off, 2 epochs over 3 of
           the tree's batches with injected pseudo-targets: every epoch's
           loss and components within 1e-4 relative, the plateau lr
           equal, the eval's predictions and graphs within 1e-4
  convert  (main path convert) `cli convert` of the fixture into a run
           directory, `eval --out` on the card (every metric within 1e-4
           of `eval --device cpu`), `train --resume --epochs 1` on the
           card from it (resumed from step 0, the loss finite), 64
           synthetic clips at batch 16; K1, K2 counted
  temporal (main path temporal) every family's steps on the time axis:
           a gloo group of 2 processes with both ranks on cuda:0 (NCCL
           takes one rank a card; gloo takes the port's CUDA
           collectives), the (1 data x 2 time) mesh: C at mini3d's width
           (B=8, 8x64x64), B with attention at memory_ae's width (B=4,
           T=128; K6 over the gathered T, K3 in eval) and A at full width
           (B=4, 16x240x360), one train step and the eval step each
           against the one-rank step of the same global batch in this
           process: metrics within 1e-4 relative, every parameter within
           2 lr, at most 0.1% beyond 2e-5 + 2e-4 |p|, statistics, bank and
           eval outputs within 1e-5 + 1e-4 |ref|, the ranks bit-identical;
           the counts are each rank's, summed
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
           rate in float32 and the CUDA cores' beside them;
           the train-step rows of d, b, d64 and b_attn are phase
           steps_per_call's eager rows
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
long_score, long_train, train, family_b_train, family_b_serve, attn_train,
family_c_train, family_a_train, video_score_d, stream_d, video_score_b,
video_score_d64, video_score_a, video-e, report, export_<artefact>,
graph_<path> (after the capture, over the replays), steps_per_call_fit,
parallel, compat, convert, temporal) and read just after it;
families C, A and E must read 0 for every kernel.  The last lines are the kernels summary, the card's
nvidia-smi name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import functools
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Optional

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
# ... with every ReLU's mask pinned to float64's; a ReLU decision that the
# unpinned float32 forward flips must lie within FLIP_NEAR of its layer's
# largest |float64| pre-activation (float32 rounding, not a wrong value)
FLIP_NEAR = 1e-5
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
# phase video: UCSD Ped2's test split at its layout and size (12 videos of
# 180 gray 240x360 PGM frames, `_gt` mask folders), written from its own
# seed; the CPU scores the first VIDEO_CPU_VIDEOS of each path, and the
# decoder is held to the written bytes on VIDEO_DECODED frames
VIDEO_VIDEOS, VIDEO_FRAMES, VIDEO_HW, VIDEO_SEED = 12, 180, (240, 360), 12
VIDEO_CPU_VIDEOS, VIDEO_DECODED = 2, 8
# tolerances: card vs CPU per window and frame (f32), per-video frame AUC,
# and the stream (B=1) against the batched scorer (B<=64) on the card
VIDEO_CPU_TOL, VIDEO_AUC_TOL, STREAM_TOL = 1e-4, 1e-3, 1e-5
# phase family_e: the bbox_viz model at its full default width from its own
# seed, E_CLIPS clips card vs CPU within E_TOL (features within E_TOL of
# their largest magnitude), TF32 off; then every video of phase video's
# tree, the card's per-video frame AUCs equal to the CPU's
E_SEED, E_CLIPS, E_TOL = 15, 128, 1e-5
# phase report: phase video's sizes in RGB PPM (12 videos of 180 240x360
# frames), its own seed; `cli report` with the fixture on the card and on
# the CPU, at a threshold between two CPU window scores that keeps
# REPORT_MIN_CLIPS to REPORT_MAX_CLIPS clips, no window within
# REPORT_MARGIN of it and no two kept scores within REPORT_TIE of each
# other (their order gives the clip ids; the fixture's windows card vs CPU
# differ by up to 5.3e-7, PR 12); scores within REPORT_TOL
REPORT_SEED, REPORT_MARGIN, REPORT_TIE, REPORT_TOL = 16, 1e-4, 2e-6, 1e-5
REPORT_MIN_CLIPS, REPORT_MAX_CLIPS = 5, 40
# family C (phase family_c): the mini3d preset's clip and batch; its fit
# on synthetic clips (2 epochs, and 1 + a resumed 1)
C_CLIP, C_BATCH, C_TRAIN_CLIPS, C_EVAL_CLIPS = (8, 64, 64, 1), 8, 256, 64
C_PARAMS = 18337
E_PARAMS = 517505
# family A (phase family_a) at full width: the causal_pipeline preset's
# clip (16 gray frames of 240x360) and batch; its fit (2 epochs, and 1 + a
# resumed 1, the cosine schedule's length fixed at 2)
A_CLIP, A_BATCH, A_TRAIN_CLIPS, A_EVAL_CLIPS = (16, 240, 360, 1), 4, 32, 16
# card vs CPU over the train steps of families C and A, step by step
# (`step_parity`): each step taken on the card and on the CPU from the CPU
# run's train state before it, every ReLU mask and max-pool argmax pinned
# to the CPU's float64 forward (unpinned, family A's first step flips 17
# ReLU decisions within 5.6e-7 of their layer's largest |pre-activation|
# and one max pool between card and CPU, moving a leaf's gradient by 1.7%,
# and its 3-step runs part by 5% in the loss).  Each step: the metrics
# within STEP_RTOL; every parameter entry whose CPU gradient lies above
# STEP_TINY_REL of its leaf's largest |entry| ("steady") within
# STEP_PARAM_ATOL (Adam moves it by lr times about the gradients'
# relative difference), every entry within 2 lr, at most STEP_FAR_SHARE
# of them beyond STEP_PARAM_ATOL; the running statistics within
# STEP_STATS_REL of each leaf's largest entry.  Sound readings (H100,
# scripts/probe_family_parity.py): metrics 1.2e-6, steady entries 5.6e-6,
# 3.1e-5 of the entries beyond 2e-5, every entry within 3.0e-4 (about an
# lr), statistics 4.6e-7; + 1e-3 of the leaf's largest entry planted on
# the card's gradient of the first conv weight moves steady entries 2.1e-5
# to 5.5e-5 (C's first step, A's three), a 1.001 scaling none (Adam's
# update is blind to a leaf's scale: the gradient rule below catches it)
STEP_RTOL, STEP_PARAM_ATOL, STEP_STATS_REL = 1e-4, 2e-5, 1e-5
STEP_TINY_REL, STEP_FAR_SHARE = 1e-3, 1e-3
# ... and each step's gradient on the card (decisions pinned) against the
# CPU's float64 one: each leaf's e_card (largest difference over float64's
# largest entry) within GRAD_F64_REL + GRAD_KAPPA * e_cpu, e_cpu the CPU's
# own float32 error.  cuDNN's float32 conv backward is several times less
# accurate than the CPU's (e_card up to 3.4e-4 against e_cpu 8.0e-5 in
# family A's first BatchNorm bias), so the 1e-5 of long_train_parity's
# bound does not fit these convs.  Sound steps read up to 0.81 of the
# bound; the card's gradient of the first conv weight planted x 1.001
# 1.01 to 5.4 times it, lowest where the CPU's own error is largest
# (family C's first step, e_cpu 2.2e-4) (scripts/probe_family_parity.py)
GRAD_F64_REL = 1e-4
# family A's bf16 step against its f32 step: the loss within A_BF16_RTOL
A_BF16_RTOL = 2e-2
# the detector's decisions: no box coordinate within A_MARGIN pixels of a
# validity threshold
A_MARGIN = 1e-2
A_PARAMS, A_ANCHOR_PARAMS = 7868720, 1318119
# phase steps_per_call: SPC_STEPS eager steps against SPC_STEPS / SPC_K
# replays of a captured graph of SPC_K steps on every train path
# (SPC_FAMILIES, `step_config`); step times over SPC_CALLS calls, eager
# and as graphs of SPC_TIMES_K steps; `Trainer.fit` on SPC_FIT_CLIPS
# clips, 6 batches of 256 an epoch (one chunk of 4 and 2 single steps)
SPC_SEED, SPC_K, SPC_STEPS, SPC_CALLS = 22, 4, 8, 20
SPC_TIMES_K = (4, 16)
SPC_FAMILIES = ("d", "d64", "b", "b_attn", "c", "a", "a_remat")
SPC_FIT_CLIPS, SPC_FIT_EPOCHS = 1536, 2
# the generators of phases family_c and family_a (their clips, and family
# A's shared VAE draws), apart from the stream of the earlier phases
C_SEED, A_SEED, A_NOISE_SEED = 13, 14, 21
# phase export: each family's scorer through `cli export` on the card, at
# these request buckets (family A's: it is 16 240x360 frames a clip),
# every output within EXPORT_TOL of the eager scorer (float32, TF32 off),
# EXPORT_LAT_CALLS calls a latency median; its own generator
EXPORT_SEED, EXPORT_TOL, EXPORT_LAT_CALLS = 23, 1e-5, 5
EXPORT_BUCKETS, EXPORT_BUCKETS_A = (1, 8, 32), (1, 4)
# phase parallel: an NCCL process group of one rank; family D at full
# width, PAR_EAGER eager steps then one captured graph of PAR_K steps at
# B=PAR_BATCH, family B (memory_ae) one step and eval at B=PAR_B_BATCH,
# the sharded scorers on PAR_SCORE_CLIPS clips, the T=64 halo forward on
# PAR_T64_CLIPS clips within PAR_T64_TOL (F.conv3d against K1), step times
# over PAR_TIME_CALLS eager steps; its own generator
PAR_SEED, PAR_BATCH, PAR_EAGER, PAR_K = 24, 256, 4, 4
PAR_B_BATCH, PAR_SCORE_CLIPS, PAR_T64_CLIPS, PAR_T64_TOL = 64, 64, 16, 1e-5
PAR_TIME_CALLS = 20
# phase compat: an Avenue-layout tree of RGB 64x64 PPM frames (train and
# test videos, frames a video), the drivers' epochs, and the card-vs-CPU
# check: the fixture, dropout off, injected pseudo-targets at this rate
COMPAT_SEED, COMPAT_VIDEOS, COMPAT_FRAMES = 31, (6, 2), 40
COMPAT_EPOCHS, COMPAT_PARITY_BATCHES, COMPAT_PSEUDO_RATE = 2, 3, 0.25
COMPAT_LOSS_RTOL = 1e-4
# phase convert: the synthetic clips of `eval` and `train --resume`
CONVERT_CLIPS, CONVERT_BATCH = 64, 16
# phase temporal: a 2-process gloo group with both ranks on cuda:0, the
# (1 data x 2 time) mesh against the one-rank step of the same global
# batch: name -> (rows, clip (T, H, W, C))
TEMPORAL_SEED = 41
TEMPORAL_CASES = {"c": (C_BATCH, C_CLIP), "b_attn": (ATTN_PARITY_BATCH,
                                                     ATTN_CLIP),
                  "a": (A_BATCH, A_CLIP)}
# metrics rtol; parameters: every entry within 2 lr of the one-rank
# step's, at most this share beyond atol + rtol * |one-rank|; running
# statistics, bank and eval outputs within TEMPORAL_OUT_TOL (rtol, atol)
TEMPORAL_METRIC_RTOL, TEMPORAL_FAR_SHARE = 1e-4, 1e-3
TEMPORAL_PARAM_TOL, TEMPORAL_OUT_TOL = (2e-4, 2e-5), (1e-4, 1e-5)
COLLECTIVES = ("gather", "gather_backward", "all_reduce_sum",
               "all_reduce_sum_backward", "reduce_gradients",
               "halo_exchange", "halo_exchange_backward")
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
    """Every kernel wrapper's launch counter (`train/graphs.py`)."""
    from cvad_tpu_torch.train.graphs import read_counters

    return read_counters()


def reset_counts() -> None:
    from cvad_tpu_torch.train.graphs import launch_counters

    for obj, attr in launch_counters().values():
        setattr(obj, attr, 0)


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


class Relus:
    """While active (``with``), `torch.nn.functional.relu`, which family D's
    ReLUs call (and `nn.ReLU` too), records or replays each call's mask,
    matched by call order.  Without `masks` it records, for each call, the
    mask x > 0 and each entry's |x| over that layer's largest |x| (`rel`),
    and returns relu(x).  With `masks` (a recording's
    `masks`) it returns x * mask: the value and the gradient of a ReLU
    that decides as the recording did, whatever x's own sign; a call past
    the recording's count, a shape that differs, or fewer calls than
    recorded fail the check.  No model code changes."""

    def __init__(self, masks=None):
        self.pinned = masks
        self.masks, self.rel = [], []

    def __enter__(self):
        import torch.nn.functional as F

        self._real = F.relu
        F.relu = self._relu
        return self

    def __exit__(self, exc_type, *_):
        import torch.nn.functional as F

        F.relu = self._real
        if exc_type is None and self.pinned is not None:
            check(len(self.masks) == len(self.pinned),
                  f"{len(self.masks)} ReLU calls replayed "
                  f"{len(self.pinned)} recorded masks")

    def _relu(self, x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
        if self.pinned is None:
            a = x.detach().abs()
            self.masks.append((x.detach() > 0).cpu())
            self.rel.append((a / a.max()).cpu())
            return self._real(x)
        j = len(self.masks)
        check(j < len(self.pinned) and self.pinned[j].shape == x.shape,
              f"ReLU call {j} of shape {tuple(x.shape)} has no recorded "
              f"mask of its shape")
        self.masks.append(None)  # counts the calls
        return x * self.pinned[j].to(x.device, x.dtype)


class Pools:
    """While active (``with``), `torch.nn.functional.max_pool3d` (family
    C's pools) and `max_pool2d` (family A's backbone) record each call's
    argmax indices (without `indices`) or take the recorded ones (with a
    recording's `indices`), matched by call order over both: the value and
    the gradient of a pool that decides as the recording did, however close
    a window's two largest values lie.  A call past the recording's count,
    a shape that differs, or fewer calls than recorded fail the check."""

    NAMES = ("max_pool3d", "max_pool2d")

    def __init__(self, indices=None):
        self.pinned = indices
        self.indices = []

    def __enter__(self):
        import torch.nn.functional as F

        self._real = {n: getattr(F, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(F, n, functools.partial(self._pool, self._real[n]))
        return self

    def __exit__(self, exc_type, *_):
        import torch.nn.functional as F

        for n in self.NAMES:
            setattr(F, n, self._real[n])
        if exc_type is None and self.pinned is not None:
            check(len(self.indices) == len(self.pinned),
                  f"{len(self.indices)} max-pool calls replayed "
                  f"{len(self.pinned)} recorded")

    def _pool(self, real, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        kwargs.pop("return_indices", None)
        out, idx = real(x, *args, return_indices=True, **kwargs)
        if self.pinned is None:
            self.indices.append(idx.cpu())
            return out
        j = len(self.indices)
        check(j < len(self.pinned) and self.pinned[j].shape == idx.shape,
              f"max-pool call {j} has no recorded indices of its shape")
        self.indices.append(None)  # counts the calls
        idx = self.pinned[j].to(x.device)
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)


def step_forward(cfg, model, clips: np.ndarray, step: int,
                 dtype: torch.dtype = torch.float32) -> tuple:
    """Family D's train-mode forward of one train step on `model`'s device
    (`train/tasks.py`'s prep and generator seed), in `dtype`: a float64
    copy of the model takes the prepped clips cast to float64.  Returns
    the model that ran and its outputs."""
    from cvad_tpu_torch.train.tasks import prep_clips, step_seed

    dev = next(model.parameters()).device
    if next(model.parameters()).dtype != dtype:
        model = copy.deepcopy(model).to(dtype)
    x = prep_clips(torch.from_numpy(clips).to(dev),
                   cfg.data.normalize_clamp).to(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(step_seed(1, step))
    return model, model.train()(x, generator=gen)


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
    from cvad_tpu_torch.train.tasks import card_numerics

    with card_numerics():
        model, (scores, adj, _) = step_forward(cfg, model, clips, step,
                                               dtype)
        dev = scores.device
        total, _ = improved_loss(scores, adj,
                                 torch.from_numpy(targets).to(dev, dtype),
                                 cfg.loss)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(total, params)
    return {n: g.detach().cpu() for n, g in zip(names, grads)}


def relu_flips(cfg, model, clips: np.ndarray, step: int,
               ref: Relus) -> dict:
    """The ReLU decisions of `model`'s unpinned float32 forward of one step
    against float64's (`ref`, a recording): by layer, how many entries
    decide otherwise (`flips`), how many of those lie farther from 0 than
    FLIP_NEAR of the layer's largest |float64| entry (`far`, which a
    rounding difference cannot give), and the largest |float64| over that
    entry among the flipped ones (`rel`, 0 where none flipped): the
    reading that FLIP_NEAR separates."""
    from cvad_tpu_torch.train.tasks import card_numerics

    with torch.no_grad(), card_numerics(), Relus() as rec:
        step_forward(cfg, model, clips, step)
    check(len(rec.masks) == len(ref.masks),
          f"{len(rec.masks)} ReLU calls against float64's {len(ref.masks)}")
    flips = [m != r for m, r in zip(rec.masks, ref.masks)]
    rel = [float(r[f].max()) if f.any() else 0.0
           for f, r in zip(flips, ref.rel)]
    return {"flips": [int(f.sum()) for f in flips],
            "far": [int((f & (r > FLIP_NEAR)).sum())
                    for f, r in zip(flips, ref.rel)],
            "rel": rel}


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
    """Per-step gradients from the same parameters, held against float64
    with every ReLU's decision pinned to float64's.  The CPU runs the
    steps from seed 0 in float32; before each it takes, from a float64
    copy of its parameters, the step's float64 gradient, recording each
    ReLU's mask (`Relus`), and then its float32 gradient with those masks
    pinned.  The card takes the pinned float32 gradient at the same
    parameters on the same batch, and so does the `witness` model on the
    card, where one is given as (config, model).  The unpinned float32
    forwards of the card and the CPU give each step's flipped decisions
    (`relu_flips`).  Returns, for each step, every leaf's e_card and e_cpu
    (and e_witness), the largest difference of the card's (the CPU's
    float32, the witness's) pinned gradient from the float64 one over its
    largest entry; each step's flips; the card's launches over its
    gradient calls (the witness's and the flip forwards' not counted); and
    the CPU run's metrics and final state."""
    from cvad_tpu_torch.train.state import float_metrics

    cpu = task.init_state(0, "cpu")
    card = task.init_state(0, "cuda").model
    launched = dict.fromkeys(counts(), 0)
    steps, flips, metrics = [], [], []
    for i in range(clips.shape[0]):
        args = (clips[i], targets[i], cpu.step)
        with Relus() as ref:
            g64 = step_grads(cfg, cpu.model, *args, dtype=torch.float64)
        with Relus(ref.masks):
            g32 = step_grads(cfg, cpu.model, *args)
        card.load_state_dict(cpu.model.state_dict(), strict=True)
        before = counts()
        with Relus(ref.masks):
            got = step_grads(cfg, card, *args)
        for k, v in counts().items():
            launched[k] += v - before[k]
        errs = {"e_card": rel_errs(got, g64), "e_cpu": rel_errs(g32, g64)}
        if witness:
            wcfg, wmodel = witness
            wmodel.load_state_dict(cpu.model.state_dict(), strict=True)
            with Relus(ref.masks):
                errs["e_witness"] = rel_errs(
                    step_grads(wcfg, wmodel, *args), g64)
        steps.append({n: {k: e[n] for k, e in errs.items()} for n in g64})
        flips.append({name: relu_flips(cfg, model, clips[i], cpu.step, ref)
                      for name, model in (("card", card),
                                          ("cpu", cpu.model))})
        cpu, m = task.train_step(cpu, {
            "clips": torch.from_numpy(clips[i]),
            "pseudo_targets": torch.from_numpy(targets[i])}, 1)
        metrics.append(float_metrics(m))
    return steps, flips, launched, metrics, cpu.model.state_dict()


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


def parity_holds(step: dict, flips: dict) -> bool:
    """long_train_parity's rule for one step: every leaf's pinned e_card
    within its bound, and no flipped decision far from 0."""
    return (all(e["e_card"] <= grad_bound(e["e_cpu"]) for e in step.values())
            and not any(sum(f["far"]) for f in flips.values()))


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
    parameters, against float64 arithmetic, with every ReLU deciding as
    in float64: at each of the 3 steps the card computes the float32
    gradient at the CPU run's parameters on that step's batch, the CPU
    its float64 gradient (recording each ReLU's mask) and its float32
    one, both float32 gradients with the masks pinned to float64's
    (`Relus`), and for every leaf e_card <= GRAD_ABS + GRAD_KAPPA * e_cpu,
    e_x being the largest |x - float64| over the largest |float64| entry.
    The card may lie farther from exact arithmetic than the CPU's own
    float32 only by the factor GRAD_KAPPA, and by GRAD_ABS (the rule of
    the kernels' own checks) beside it: float32 sums in another order, not
    a fault.  A pre-activation within float32 rounding of 0 may take the
    other side of 0 than in float64, and its ReLU then passes a gradient
    float64 stops, or the reverse: a decision, not arithmetic, which the
    pinned masks take out of the rule.  Those flips are counted, by layer,
    in the unpinned float32 forwards of the card and of the CPU, and each
    must lie within FLIP_NEAR of its layer's largest |float64| entry: a
    kernel that computes a wrong pre-activation flips decisions far from
    0 and fails there."""
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
    grads, flips, grad_rose, mc, pc = long_grad_parity(task, cfg, clips,
                                                       targets)
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
          "grad_bound": {"abs": GRAD_ABS, "kappa": GRAD_KAPPA,
                         "relu_masks": "float64's", "flip_near": FLIP_NEAR},
          "grad_worst_leaf_by_step": [worst_leaf(g) for g in grads],
          "relu_flips_by_step": flips})
    check(err_m <= 1e-4, f"long-window card vs CPU metrics differ by {err_m}")
    for i, (step, flip) in enumerate(zip(grads, flips)):
        check(parity_holds(step, flip),
              f"long-window step {i + 1}: the card's gradient (ReLU masks "
              f"pinned to float64's) against e_card <= {GRAD_ABS} + "
              f"{GRAD_KAPPA} x e_cpu, worst leaf {worst_leaf(step)}; ReLU "
              f"decisions flipped (none may lie past {FLIP_NEAR} of the "
              f"layer's largest entry): {flip}")


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


class Watched:
    """A batch scorer that times its calls (`seconds`) and fails the check
    on a clip whose largest value is 0: a decoder that cannot read the
    frames gives zero frames, which would score without an error."""

    def __init__(self, fn):
        self.fn, self.seconds, self.clips = fn, 0.0, 0

    def __call__(self, batch: np.ndarray):
        check(bool((batch.reshape(len(batch), -1).max(1) > 0).all()),
              "a decoded clip is all zeros: the frames were not decoded")
        t0 = time.perf_counter()
        out = self.fn(batch)
        self.seconds += time.perf_counter() - t0
        self.clips += len(batch)
        return out


def video_tree(root: Path) -> tuple:
    """Writes phase video's tree with the port's writer; returns the test
    split's videos, their frame labels (from the `_gt` masks) and the
    seconds the writing took."""
    from cvad_tpu_torch.data.frames import scan_video_folders
    from cvad_tpu_torch.data.ground_truth import load_gt_frame_labels
    from cvad_tpu_torch.data.synthetic import write_synthetic_video_tree

    t0 = time.perf_counter()
    write_synthetic_video_tree(
        str(root), splits=("Test",), videos_per_split=VIDEO_VIDEOS,
        frames_per_video=VIDEO_FRAMES, hw=VIDEO_HW, channels=1, fmt="pgm",
        seed=VIDEO_SEED, write_gt=True)
    write_s = time.perf_counter() - t0
    videos = scan_video_folders(str(root / "Test"))
    labels = load_gt_frame_labels(str(root), "Test",
                                  [n for n, _ in videos])
    check(len(videos) == VIDEO_VIDEOS and len(labels) == VIDEO_VIDEOS
          and all(len(f) == VIDEO_FRAMES for _, f in videos),
          f"the tree holds {len(videos)} videos, {len(labels)} with labels")
    return videos, labels, write_s


def check_decoder(videos: list) -> dict:
    """The port's decoder is its own build of native/decoder.cpp in
    cvad_tpu_torch/build/ and loads here; VIDEO_DECODED frames decoded at
    their own size equal the bytes the writer put in the files, x / 255 in
    float32, bit for bit."""
    from cvad_tpu_torch.data import native_decoder as nd

    t0 = time.perf_counter()
    lib = nd.load_library()
    load_s = time.perf_counter() - t0
    check(lib is not None, "the port's native decoder did not build or load "
                           "(no decoder reads the frames on this host): "
                           f"{nd.last_error}")
    check(Path(lib._name) == nd.library_path()
          and nd.library_path().parent == nd.BUILD_DIR,
          f"the decoder loaded from {lib._name}")
    h, w = VIDEO_HW
    paths = videos[0][1][:VIDEO_DECODED]
    got = nd.decode_clip(paths, VIDEO_HW, 1)
    header = f"P5\n{w} {h}\n255\n".encode()
    inv255 = np.float32(1.0) / np.float32(255.0)
    for p, frame in zip(paths, got):
        raw = Path(p).read_bytes()
        check(raw.startswith(header) and len(raw) == len(header) + h * w,
              f"{p} is not the written {w}x{h} PGM")
        px = np.frombuffer(raw[len(header):], np.uint8).reshape(h, w, 1)
        check(np.array_equal(frame, px.astype(np.float32) * inv255),
              f"{p} decodes to other values than its bytes")
    return {"library": str(Path(lib._name).relative_to(ROOT)),
            "build_and_load_s": load_s, "suffixes": nd.supported_suffixes(),
            "frames_bit_identical": len(paths), "frame_hw": list(VIDEO_HW)}


def score_videos(score_fn, cfg, videos: list, labels: dict) -> tuple:
    """Every video through `VideoScorer` and `frame_level_auc`; returns the
    AUC report, each video's `score_video` result by name, and the seconds
    (total and inside the score calls)."""
    from cvad_tpu_torch.evaluation.frame_auc import frame_level_auc
    from cvad_tpu_torch.evaluation.scoring import VideoScorer

    watched = Watched(score_fn)
    scorer = VideoScorer(watched, cfg)
    names = {frames[0]: name for name, frames in videos}
    results = {}

    def score_video(frames):
        results[names[frames[0]]] = out = scorer.score_video(frames)
        return out

    t0 = time.perf_counter()
    report = frame_level_auc(score_video, videos, labels)
    return report, results, time.perf_counter() - t0, watched.seconds


def video_path(name: str, score_fn, cfg, videos: list, labels: dict,
               on_path: str, card: str) -> tuple:
    """One scoring path of phase video on the card: the launch counts set
    to 0 just before and read just after; `on_path`'s counter must rise
    and every other stay 0 (every counter, where `on_path` is None).  Emits the path's line; returns its launches,
    AUC report and per-video results."""
    reset_counts()
    report, results, total_s, score_s = score_videos(score_fn, cfg, videos,
                                                     labels)
    launched = counts()
    windows = sum(len(r["scores"]) for r in results.values())
    frames = sum(len(f) for _, f in videos)
    emit({"phase": "video", "path": name, "videos": len(videos),
          "frames": frames, "windows": windows,
          "clip": [cfg.clip_len, *cfg.frame_size, cfg.channels],
          "stride": cfg.stride, "seconds": total_s,
          "decode_s": total_s - score_s, "score_s": score_s,
          "frames_per_s": frames / total_s,
          "windows_per_s": windows / total_s,
          "score_windows_per_s": windows / score_s, "launches": launched,
          **{k: report[k] for k in ("frame_auc", "frame_auc_normalized",
                                    "macro_auc", "n_frames",
                                    "anomalous_frames")},
          "card": card})
    check(report["frame_auc"] is not None
          and report["n_frames"] == frames
          and all(np.isfinite(r["scores"]).all() for r in results.values()),
          f"{name}: frame AUC {report['frame_auc']}")
    check((on_path is None or launched[on_path] > 0)
          and all(v == 0 for k, v in launched.items() if k != on_path),
          f"{name} launched {launched}")
    return launched, report, results


def video_vs_cpu(name: str, cpu_fn, cfg, videos: list, labels: dict,
                 card: dict, report: dict) -> dict:
    """The first VIDEO_CPU_VIDEOS videos scored by the port on the CPU
    against the card's results: window and frame scores within
    VIDEO_CPU_TOL, each per-video frame AUC within VIDEO_AUC_TOL."""
    part = videos[:VIDEO_CPU_VIDEOS]
    cpu_report, cpu, _, _ = score_videos(cpu_fn, cfg, part, labels)
    errs = {"window": 0.0, "frame": 0.0, "auc": 0.0}
    for v, _ in part:
        check(np.array_equal(cpu[v]["starts"], card[v]["starts"]),
              f"{name}: {v}'s windows differ on the CPU")
        errs["window"] = max(errs["window"], float(np.abs(
            cpu[v]["scores"] - card[v]["scores"]).max()))
        errs["frame"] = max(errs["frame"], float(np.abs(
            cpu[v]["frame_scores"] - card[v]["frame_scores"]).max()))
        a, b = cpu_report["per_video_auc"][v], report["per_video_auc"][v]
        check((a is None) == (b is None), f"{name}: {v}'s AUC {a} vs {b}")
        if a is not None:
            errs["auc"] = max(errs["auc"], abs(a - b))
    out = {"path": name, "videos": [v for v, _ in part],
           "per_video_auc_card": {v: report["per_video_auc"][v]
                                  for v, _ in part},
           "per_video_auc_cpu": cpu_report["per_video_auc"],
           "max_window_err": errs["window"], "max_frame_err": errs["frame"],
           "max_auc_diff": errs["auc"]}
    check(errs["window"] <= VIDEO_CPU_TOL and errs["frame"] <= VIDEO_CPU_TOL
          and errs["auc"] <= VIDEO_AUC_TOL, f"{name} card vs CPU: {out}")
    return out


def stream_video(score_fn, cfg, video: tuple, ref: dict, card: str
                 ) -> dict:
    """One video replayed frame by frame through `StreamingScorer` (B=1) on
    the card, each frame decoded by the port's dataset as `VideoScorer`'s
    windows are (uint8, then / 255 in the scorer): the windows equal
    `ref`'s (the batched scorer's) within STREAM_TOL, the launch counts
    read over the stream alone."""
    from cvad_tpu_torch.data.datasets import ClipDataset
    from cvad_tpu_torch.data.frames import clip_windows
    from cvad_tpu_torch.evaluation.streaming import StreamingScorer

    name, frames = video
    one = clip_windows([(name, frames)], 1, 1)
    ds = ClipDataset(one, np.zeros(len(one), np.float32),
                     cfg.replace(clip_len=1, stride=1))
    watched = Watched(score_fn)
    stream = StreamingScorer(watched, clip_len=cfg.clip_len,
                             stride=cfg.stride)
    reset_counts()
    t0 = time.perf_counter()
    for i in range(len(one)):
        stream.push(ds.get_uint8(i)[0][0])
    total_s = time.perf_counter() - t0
    launched = counts()
    starts = np.array([w.start for w in stream.windows])
    scores = np.array([w.score for w in stream.windows], np.float32)
    check(np.array_equal(starts, ref["starts"]),
          f"the stream fired windows {starts.tolist()}")
    err = float(np.abs(scores - ref["scores"]).max())
    err_f = float(np.abs(stream.frame_scores() - ref["frame_scores"]).max())
    out = {"phase": "video", "path": "stream_d", "video": name,
           "frames": len(frames), "windows": len(starts), "batch": 1,
           "seconds": total_s, "score_s": watched.seconds,
           "decode_s": total_s - watched.seconds,
           "frames_per_s": len(frames) / total_s,
           "windows_per_s": len(starts) / total_s, "launches": launched,
           "max_window_err_vs_batched": err,
           "max_frame_err_vs_batched": err_f, "card": card}
    emit(out)
    check(max(err, err_f) <= STREAM_TOL,
          f"stream vs batched scores differ by {err}, {err_f}")
    check(launched["tfold_conv1"] > 0
          and all(v == 0 for k, v in launched.items() if k != "tfold_conv1"),
          f"stream_d launched {launched}")
    return launched


def stack_batches(batches: list) -> dict:
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def graph_vs_eager(rng: np.random.Generator, family: str) -> dict:
    """From one initial state (seed 0), SPC_STEPS float32 eager steps
    against SPC_STEPS / SPC_K replays of a captured graph of SPC_K steps
    on the same batches: every state-dict entry (parameters, BatchNorm
    statistics, family B's bank), Adam's moments, count and lr, `step`
    and the summed metric vector bit-identical; the launch counts of the
    replays (the counts set to 0 after the capture) equal the eager
    steps'."""
    from cvad_tpu_torch.train.graphs import StepGraph
    from cvad_tpu_torch.train.tasks import build_task

    cfg, batch_size, clip = step_config(family, "float32")
    task = build_task(cfg)
    seed = cfg.train.seed + 1
    batches = step_batches(rng, SPC_STEPS, batch_size, clip)
    t0 = time.perf_counter()
    eager = task.init_state(0, "cuda")
    reset_counts()
    total, keys = None, None
    for b in batches:
        eager, m = task.train_step(eager, b, seed)
        keys = sorted(m)
        vec = torch.stack([m[k].float() for k in keys])
        total = vec if total is None else total + vec
    torch.cuda.synchronize()
    eager_launches = counts()
    eager_s = time.perf_counter() - t0
    graphed = task.init_state(0, "cuda")
    chunks = [stack_batches(batches[i:i + SPC_K])
              for i in range(0, SPC_STEPS, SPC_K)]
    t0 = time.perf_counter()
    graph = StepGraph(task, graphed, seed, chunks[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    g_total = None
    for ch in chunks:
        _, g_total = graph.replay(graphed, ch, g_total)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    graph_launches = counts()
    sa, sb = eager.model.state_dict(), graphed.model.state_dict()
    differ = {k: float((sa[k].double() - sb[k].double()).abs().max())
              for k in sa if not torch.equal(sa[k], sb[k])}
    differ |= {f"opt.{k}": float((getattr(eager.opt_state, k).double()
                                  - getattr(graphed.opt_state, k).double())
                                 .abs().max())
               for k in ("mu", "nu", "count", "lr")
               if not torch.equal(getattr(eager.opt_state, k),
                                  getattr(graphed.opt_state, k))}
    out = {"family": family, "dtype": "float32", "B": batch_size,
           "T": clip[0], "steps": SPC_STEPS, "K": SPC_K,
           "replays": len(chunks), "metric_keys": keys,
           "state_entries": len(sa) + 4, "differ": dict(list(
               differ.items())[:8]), "n_differ": len(differ),
           "step": [eager.step, graphed.step],
           "metrics_equal": keys == graph.keys and bool(
               torch.equal(total, g_total)),
           "metric_sum": total.tolist(),
           "eager_launches": {k: v for k, v in eager_launches.items() if v},
           "graph_launches": {k: v for k, v in graph_launches.items() if v},
           "eager_s": eager_s, "capture_s": capture_s, "replay_s": graph_s}
    out["bit_identical"] = (not differ and eager.step == graphed.step
                            and out["metrics_equal"])
    del graph, eager, graphed, batches, chunks
    torch.cuda.empty_cache()
    return out, graph_launches


class Interrupted(Exception):
    pass


def spc_fit(workdir: Path) -> tuple:
    """`Trainer.fit` of family D (T=8, B=256, SPC_FIT_CLIPS train clips:
    6 batches an epoch, one chunk of 4 and 2 single steps; eval every
    epoch on 256 unshuffled clips) with steps_per_call=4 and the device
    cache on against steps_per_call=1 with the cache off: history and
    state bit-identical; a run with save_every_steps=4 that dies right
    after epoch 2's 'mid' checkpoint (at the chunk boundary) and a new
    trainer that resumes it, bit-identical to the uninterrupted run; the
    fit seconds with the cache on and off at K = 1 and 4, and the cache's
    fill time and bytes.  Returns the line and the K=4 cached fit's launch
    counts (the counts set to 0 just before it)."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.data.device_cache import DeviceClipCache
    from cvad_tpu_torch.train.engine import Trainer

    cfg = train_config(TRAIN_BATCH, num_epochs=SPC_FIT_EPOCHS, eval_every=1,
                       save_interval=0)
    t0 = time.perf_counter()
    train_loader = BatchLoader(build_dataset(cfg.data, "Train",
                                             SPC_FIT_CLIPS),
                               TRAIN_BATCH, shuffle=True, seed=cfg.data.seed,
                               transfer_dtype="uint8")
    eval_loader = BatchLoader(build_dataset(cfg.data, "Test", EVAL_CLIPS),
                              TRAIN_BATCH, transfer_dtype="uint8")
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = DeviceClipCache(train_loader, "cuda")
    torch.cuda.synchronize()
    fill = {"clips": len(train_loader.dataset), "bytes": cache.nbytes,
            "fill_s": time.perf_counter() - t0}
    del cache

    def config(k: int, mode: str, **train):
        return cfg.replace(train=cfg.train.replace(
            steps_per_call=k, device_cache=mode, **train))

    runs, fit_s, launches = {}, {}, None
    for name, k, mode in (("k1_off", 1, "off"), ("k4_on", 4, "on"),
                          ("k1_on", 1, "on"), ("k4_off", 4, "off")):
        if name == "k4_on":
            reset_counts()
        t0 = time.perf_counter()
        runs[name] = Trainer(config(k, mode), out_dir=str(workdir / name))
        runs[name].fit(train_loader, eval_loader)
        torch.cuda.synchronize()
        fit_s[name] = time.perf_counter() - t0
        if name == "k4_on":
            launches = counts()

    class Dying(Trainer):
        def _save_mid(self, epoch, count, total_vec):
            super()._save_mid(epoch, count, total_vec)
            if epoch == SPC_FIT_EPOCHS:
                raise Interrupted

    mid_cfg = config(4, "on", save_every_steps=4)
    died = False
    try:
        Dying(mid_cfg, out_dir=str(workdir / "mid")).fit(train_loader,
                                                         eval_loader)
    except Interrupted:
        died = True
    resumed = Trainer(mid_cfg, out_dir=str(workdir / "mid"))
    resumed.restore()
    mid = dict(resumed._mid_resume or {})
    resumed.fit(train_loader, eval_loader)
    ref = runs["k1_off"]
    same = {name: same_run(ref, run) for name, run in runs.items()
            if name != "k1_off"}
    same["mid_resumed"] = same_run(ref, resumed)
    steps = SPC_FIT_EPOCHS * (SPC_FIT_CLIPS // TRAIN_BATCH)
    line = {"phase": "steps_per_call_fit", "batch": TRAIN_BATCH,
            "train_clips": SPC_FIT_CLIPS, "epochs": SPC_FIT_EPOCHS,
            "batches_per_epoch": SPC_FIT_CLIPS // TRAIN_BATCH, "K": 4,
            "train_steps": steps, "data_s": data_s, "cache_fill": fill,
            "fit_s": fit_s, "bit_identical_to_k1_off": same,
            "died_after_mid": died,
            "mid": {k: mid.get(k) for k in ("epoch", "count")},
            "train_losses": ref.history.as_dict()["train_losses"],
            "graphs": {n: len(r._multi.graphs) for n, r in runs.items()},
            "caches": {n: sum(c is not None for _, c in
                              r._device_caches.values())
                       for n, r in runs.items()},
            "launches": launches}
    check(died and mid.get("epoch") == SPC_FIT_EPOCHS
          and mid.get("count") == 4, f"the interrupted run: {died}, {mid}")
    check(all(same.values()), f"K-step / cached fits vs K=1 uncached: "
                              f"{same}")
    check(line["caches"]["k4_on"] == 2 and line["caches"]["k1_on"] == 2
          and line["caches"]["k4_off"] == 0, f"caches {line['caches']}")
    check(line["graphs"]["k4_on"] == 1 and line["graphs"]["k1_off"] == 0,
          f"graphs {line['graphs']}")
    check(launches["pairwise_l1_forward"] >= steps
          and launches["tfold_conv1"] >= steps,
          f"K1/K2 launches {launches} over {steps} steps")
    return line, launches


def phase_steps_per_call(workdir: Path, card: str) -> tuple:
    """Phase steps_per_call: K train steps in one CUDA graph, for every
    train path at full width (`graph_vs_eager`), `Trainer.fit` with the
    K-step call and the device cache (`spc_fit`), and the step times eager
    and as graphs of 4 and 16 steps in f32 and bf16.  Returns the launch
    counts of each path's replays and of the fit, and the times."""
    rng = np.random.default_rng(SPC_SEED)
    paths = {}
    t_start = time.perf_counter()
    for family in SPC_FAMILIES:
        line, launched = graph_vs_eager(rng, family)
        paths[f"graph_{family}"] = launched
        emit({"phase": "steps_per_call", **line})
        check(line["bit_identical"],
              f"{family}: {SPC_K}-step graph replays differ from eager "
              f"steps: {line['differ']}, step {line['step']}, metrics "
              f"equal {line['metrics_equal']}")
        check(line["eager_launches"] == line["graph_launches"],
              f"{family}: launches eager {line['eager_launches']} vs "
              f"graph {line['graph_launches']}")
    line, paths["steps_per_call_fit"] = spc_fit(workdir)
    emit(line)
    times = []
    for family in SPC_FAMILIES:
        for dtype in ("float32", "bfloat16"):
            for k in (1, *SPC_TIMES_K):
                times.append(train_step_times(rng, dtype, family, k))
                torch.cuda.empty_cache()
    summary = [{k: t[k] for k in ("family", "dtype", "K", "median_ms",
                                  "device_ms_per_step")}
               | {"busy": t["breakdown"]["device_busy_share"]}
               for t in times]
    emit({"phase": "steps_per_call_times", "card": card, "calls": SPC_CALLS,
          "summary": summary, "seconds": time.perf_counter() - t_start})
    return paths, times


def phase_video(state: dict, dev: dict, state_a: dict) -> dict:
    """Frame-folder video end to end on the card (see the module
    docstring), family A with `state_a`; returns each path's launch
    counts."""
    from cvad_tpu_torch.config import DataConfig, FamilyDConfig, preset
    from cvad_tpu_torch.evaluation.scoring import (make_family_b_score_fn,
                                                   make_family_d_score_fn,
                                                   make_score_fn)

    card = dev["card"]
    cfg_d = DataConfig(channels=3, clip_len=8, stride=4, frame_size=(64, 64))
    cfg_b = preset("memory_ae").data
    cfg_d64 = cfg_d.replace(clip_len=64, stride=16)
    model_d64 = FamilyDConfig(conv_group_impl="s2d", conv1_mode="tfold")
    state_b = b_checkpoint_state(np.random.default_rng(VIDEO_SEED))
    paths, vs_cpu = {}, []
    with tempfile.TemporaryDirectory(prefix="cvad_video_") as tmp:
        videos, labels, write_s = video_tree(Path(tmp))
        size = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                   if f.is_file())
        decoder = check_decoder(videos)
        emit({"phase": "video", "path": "tree", "videos": len(videos),
              "frames_per_video": VIDEO_FRAMES, "frame_hw": list(VIDEO_HW),
              "format": "pgm", "gt": "_gt mask folders",
              "bytes": size, "write_s": write_s, "decoder": decoder,
              "anomalous_frames": int(sum(v.sum() for v in
                                          labels.values()))})
        d_fn = make_family_d_score_fn(state)
        for name, fn, cpu_fn, cfg, counter in (
                ("video_score_d", d_fn,
                 make_family_d_score_fn(state, device="cpu"), cfg_d,
                 "tfold_conv1"),
                ("video_score_b", make_family_b_score_fn(state_b),
                 make_family_b_score_fn(state_b, device="cpu"), cfg_b,
                 "memory_min_cosine"),
                ("video_score_d64", make_family_d_score_fn(state, model_d64),
                 make_family_d_score_fn(state, model_d64, device="cpu"),
                 cfg_d64, "s2d_group_forward"),
                ("video_score_a", make_score_fn("a", state_a),
                 make_score_fn("a", state_a, device="cpu"),
                 preset("causal_pipeline").data, None)):
            paths[name], report, results = video_path(
                name, fn, cfg, videos, labels, counter, card)
            vs_cpu.append(video_vs_cpu(name, cpu_fn, cfg, videos, labels,
                                       results, report))
            if name == "video_score_d":
                paths["stream_d"] = stream_video(
                    d_fn, cfg_d, videos[0], results[videos[0][0]], card)
        paths["video-e"] = phase_family_e(videos, labels, card)
    emit({"phase": "video_vs_cpu", "paths": vs_cpu, "card": card})
    return paths


def phase_family_e(videos: list, labels: dict, card: str) -> dict:
    """Family E (see the module docstring) on phase video's tree; returns
    the launch counts of path video-e."""
    from cvad_tpu_torch.config import DataConfig
    from cvad_tpu_torch.evaluation.scoring import make_score_fn
    from cvad_tpu_torch.models import BBoxVizDetector
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cvad_family_e_") as tmp:
        path = Path(tmp) / "bbox_viz.pth"  # the reference's .pth format
        torch.save({"model_state_dict": BBoxVizDetector(
            seed=E_SEED).state_dict()}, path)
        state = load_torch_state_dict(str(path))
    params = sum(v.numel() for v in state.values())
    models = {}
    for dev in ("cuda", "cpu"):
        m = BBoxVizDetector()
        m.load_state_dict(state, strict=True)
        models[dev] = m.to(dev).eval()
    clips = np.random.default_rng(E_SEED).uniform(
        0, 1, (E_CLIPS, 8, 64, 64, 3)).astype(np.float32)

    def forward(dev: str) -> list:
        x = torch.from_numpy(clips).to(dev).permute(0, 4, 1, 2, 3)
        with torch.inference_mode(), no_tf32():
            return [o.cpu().numpy() for o in models[dev](x.contiguous())]

    card_out, again, cpu_out = forward("cuda"), forward("cuda"), forward("cpu")
    errs = {name: float(np.abs(a - b).max()) for name, a, b in zip(
        ("score", "adjacency", "features"), card_out, cpu_out)}
    feat_max = float(np.abs(cpu_out[2]).max())
    model_s = time.perf_counter() - t0
    emit({"phase": "family_e", "part": "model", "params": params,
          "clips": E_CLIPS, "max_abs_err": errs, "features_max": feat_max,
          "bit_identical_repeat": all(np.array_equal(a, b) for a, b in
                                      zip(card_out, again)),
          "score_mean": float(card_out[0].mean()), "seconds": model_s,
          "card": card})
    check(params == E_PARAMS and card_out[0].shape == (E_CLIPS,)
          and card_out[1].shape == (E_CLIPS, 16, 16)
          and card_out[2].shape == (E_CLIPS, 1024),
          f"family E: {params} parameters, shapes "
          f"{[o.shape for o in card_out]}")
    check(all(np.isfinite(o).all() for o in card_out),
          "family E outputs finite")
    check(errs["score"] <= E_TOL and errs["adjacency"] <= E_TOL
          and errs["features"] <= E_TOL * feat_max,
          f"family E card vs CPU: {errs} (features' largest {feat_max})")
    check(all(np.array_equal(a, b) for a, b in zip(card_out, again)),
          "family E: a second card call is not bit-identical")

    cfg = DataConfig(channels=3, clip_len=8, stride=4, frame_size=(64, 64))
    launched, report, results = video_path(
        "video-e", make_score_fn("e", state), cfg, videos, labels, None,
        card)
    cpu_report, cpu, _, _ = score_videos(
        make_score_fn("e", state, device="cpu"), cfg, videos, labels)
    win_err = max(float(np.abs(cpu[v]["scores"] - results[v]["scores"]).max())
                  for v, _ in videos)
    auc = {v: (report["per_video_auc"][v], cpu_report["per_video_auc"][v])
           for v, _ in videos}
    total_s = time.perf_counter() - t0
    emit({"phase": "family_e", "part": "video_vs_cpu", "videos": len(videos),
          "max_window_err": win_err, "per_video_auc_card_cpu": auc,
          "frame_auc": [report["frame_auc"], cpu_report["frame_auc"]],
          "seconds": total_s, "card": card})
    check(win_err <= E_TOL, f"video-e windows card vs CPU: {win_err}")
    check(all(a == b for a, b in auc.values()),
          f"video-e per-video AUCs differ card vs CPU: {auc}")
    check(total_s < 30, f"phase family_e took {total_s} s")
    return launched


def report_threshold(scores: np.ndarray) -> tuple:
    """The threshold that keeps the top k of `scores` (k from
    REPORT_MIN_CLIPS up) where no score lies within REPORT_MARGIN of it
    and no two kept ones within REPORT_TIE; returns (threshold, k)."""
    s = np.sort(scores)[::-1].astype(np.float64)
    for k in range(REPORT_MIN_CLIPS, min(REPORT_MAX_CLIPS, len(s) - 1) + 1):
        if (s[k - 1] - s[k] > 2 * REPORT_MARGIN
                and np.diff(s[:k]).max() < -REPORT_TIE):
            return float((s[k - 1] + s[k]) / 2), k
    raise RuntimeError("chip_smoke check failed: no report threshold keeps "
                       f"{REPORT_MIN_CLIPS}-{REPORT_MAX_CLIPS} windows apart "
                       f"from the rest by {2 * REPORT_MARGIN}")


def same_reports(a: Path, b: Path) -> dict:
    """Two report directories hold the same clips (ids, videos, frame
    ranges, the video distribution and the backend 'motion'), scores
    within REPORT_TOL, each clip's ``_info.json`` the same way; returns
    the largest score difference and the first report."""
    ra, rb = (json.loads((d / "anomaly_detection_report.json").read_text())
              for d in (a, b))
    err = 0.0
    check(ra["detection_backend"] == rb["detection_backend"] == "motion"
          and ra["video_distribution"] == rb["video_distribution"]
          and ra["total_clips_analyzed"] == rb["total_clips_analyzed"]
          == len(ra["clips"]) == len(rb["clips"]),
          f"reports differ: {ra['detection_backend']}, "
          f"{ra['video_distribution']} vs {rb['detection_backend']}, "
          f"{rb['video_distribution']}")
    for ca, cb in zip(ra["clips"], rb["clips"]):
        check((ca["clip_id"], ca["video_id"], ca["frame_range"])
              == (cb["clip_id"], cb["video_id"], cb["frame_range"]),
              f"report clips differ: {ca} vs {cb}")
        ia, ib = ([json.loads(p.read_text()) for p in
                   (d / ca["clip_id"]).glob("*_info.json")] for d in (a, b))
        check(len(ia) == len(ib) == 1, f"{ca['clip_id']}: info files")
        ia, ib = ia[0], ib[0]
        err = max(err, abs(ca["anomaly_score"] - cb["anomaly_score"]),
                  abs(ia.pop("anomaly_score") - ib.pop("anomaly_score")))
        check(ia == ib, f"{ca['clip_id']}: info {ia} vs {ib}")
    check(err <= REPORT_TOL, f"report scores differ by {err}")
    return {"max_score_err": err, "report": ra}


def phase_report(dev: dict) -> dict:
    """`cli report` end to end on the card and on the CPU (see the module
    docstring); returns the launch counts of path report."""
    import importlib.util

    from cvad_tpu_torch import cli
    from cvad_tpu_torch.config import DataConfig
    from cvad_tpu_torch.data.frames import scan_video_folders
    from cvad_tpu_torch.data.synthetic import write_synthetic_video_tree
    from cvad_tpu_torch.evaluation import bbox
    from cvad_tpu_torch.evaluation.scoring import (ScoredClip, VideoScorer,
                                                   make_family_d_score_fn)
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    card = dev["card"]
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "cv2")}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cvad_report_") as tmp:
        root = Path(tmp) / "tree"
        write_synthetic_video_tree(
            str(root), splits=("Test",), videos_per_split=VIDEO_VIDEOS,
            frames_per_video=VIDEO_FRAMES, hw=VIDEO_HW, channels=3,
            fmt="ppm", seed=REPORT_SEED)
        write_s = time.perf_counter() - t0
        videos = scan_video_folders(str(root / "Test"))
        check(len(videos) == VIDEO_VIDEOS
              and all(len(f) == VIDEO_FRAMES for _, f in videos),
              f"the report tree holds {len(videos)} videos")

        # the CPU's window scores choose the threshold
        t1 = time.perf_counter()
        cfg = DataConfig(channels=3, clip_len=8, stride=4,
                         frame_size=(64, 64))
        scorer = VideoScorer(make_family_d_score_fn(
            load_torch_state_dict(str(CKPT)), device="cpu"), cfg)
        scores = np.concatenate([scorer.score_video(f)["scores"]
                                 for _, f in videos])
        threshold, k = report_threshold(scores)
        choose_s = time.perf_counter() - t1
        args = [str(root / "Test"), "--checkpoint", str(CKPT),
                "--threshold", repr(threshold), "--max-clips", str(k)]

        out, seconds = {}, {}
        for name, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            out[name] = Path(tmp) / f"report_{name}"
            if name == "cuda":
                reset_counts()
            t1 = time.perf_counter()
            check(cli.main(["report", *args, "--out", str(out[name]),
                            *extra]) == 0, f"report on {name} failed")
            seconds[name] = time.perf_counter() - t1
            if name == "cuda":
                launched = counts()
        compared = same_reports(out["cuda"], out["cpu"])
        rep = compared.pop("report")
        check(rep["total_clips_analyzed"] == k,
              f"report kept {rep['total_clips_analyzed']} clips, not {k}")

        # the first clip's frames drawn by the numpy path with each run's
        # score: the same decoded frames, detections and boxes
        first = rep["clips"][0]
        frames = dict(videos)[first["video_id"]]
        lo, hi = first["frame_range"]
        viz = bbox.AnomalyVisualizer(None, "motion")
        cv2_of = bbox._cv2
        bbox._cv2 = lambda: None
        try:
            drawn = [viz.annotated_frames(ScoredClip(
                first["video_id"], lo, json.loads(
                    (out[name] / "anomaly_detection_report.json").read_text()
                )["clips"][0]["anomaly_score"], tuple(frames[lo:hi + 1])))
                for name in ("cuda", "cpu")]
        finally:
            bbox._cv2 = cv2_of
        persons = sum(drawn[0][1])
        check(all(np.array_equal(a, b) for a, b in zip(drawn[0][0],
                                                         drawn[1][0]))
              and drawn[0][1] == drawn[1][1],
              "the first clip's annotated frames differ between the runs")

        html = (out["cuda"] / "anomaly_detection_report.html").read_text()
        listed = [f"{c['clip_id']}/{f}" for c in rep["clips"]
                  for f in c["files"].values() if f]
        check(all(f"<td>{c['clip_id']}</td>" in html for c in rep["clips"])
              and all(f'href="{f}"' in html for f in listed),
              "the HTML report misses a clip or one of its files")
        written = {ext: len(list(out["cuda"].rglob(f"*.{ext}")))
                   for ext in ("png", "mp4", "json")}
        check(have["matplotlib"] or written["png"] == 0,
              "a PNG was written without matplotlib")
        check(have["cv2"] or written["mp4"] == 0,
              "an MP4 was written without cv2")
    total_s = time.perf_counter() - t0
    emit({"phase": "report", "videos": len(videos),
          "frames": len(videos) * VIDEO_FRAMES, "windows": len(scores),
          "threshold": threshold, "clips": k,
          "score_range": [float(scores.min()), float(scores.max())],
          "max_score_err": compared["max_score_err"],
          "detection_backend": rep["detection_backend"],
          "persons_in_first_clip": persons, "written": written,
          "have": have, "links": len(listed),
          "seconds": {"write_tree": write_s, "cpu_scores": choose_s,
                      "report_cuda": seconds["cuda"],
                      "report_cpu": seconds["cpu"], "total": total_s},
          "launches": launched, "card": card})
    batches = len(videos)  # one batch a video (44 windows, batches of 64)
    check(launched["tfold_conv1"] >= batches
          and all(v == 0 for key, v in launched.items()
                  if key != "tfold_conv1"),
          f"report launched {launched} for {batches} scored batches")
    check(total_s < 30, f"phase report took {total_s} s")
    return launched


def export_cases(rng: np.random.Generator) -> list:
    """The artefacts of phase export: (name, family, state dict, the
    `cli export` arguments past the family, the model config, the clip,
    the buckets, the kernel counters the artefact must advance)."""
    from cvad_tpu_torch.config import (FamilyAConfig, FamilyBConfig,
                                       FamilyCConfig, FamilyDConfig)
    from cvad_tpu_torch.models import (BBoxVizDetector,
                                       CausalPipelineDetector,
                                       MemoryVideoAutoEncoder,
                                       Simple3DCNNDetector)
    from cvad_tpu_torch.models.family_b import MemoryBankState
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    fixture = load_torch_state_dict(str(CKPT))
    attn = FamilyBConfig(**ATTN_MODEL)
    model = MemoryVideoAutoEncoder(attn, seed=0)
    memory = torch.zeros(attn.memory_size, attn.latent_dim)
    memory[:B_FILL] = torch.from_numpy(
        rng.normal(size=(B_FILL, attn.latent_dim)).astype(np.float32))
    fill = torch.tensor(B_FILL, dtype=torch.int32)
    model.set_memory_bank(MemoryBankState(memory, fill, fill))
    attn_args = ["--preset", "memory_ae", "--clip-len", str(ATTN_CLIP[0])]
    for key, value in ATTN_MODEL.items():
        attn_args += ["--set", f"model.{key}={value}"]
    return [
        ("d", "d", fixture, [], FamilyDConfig(), CLIP, EXPORT_BUCKETS,
         {"tfold_conv1"}),
        ("d64", "d", fixture, ["--set", "model.conv_group_impl=s2d",
                               "--clip-len", str(LONG_CLIP[0])],
         FamilyDConfig(conv_group_impl="s2d"), LONG_CLIP, EXPORT_BUCKETS,
         {"s2d_group_forward"}),
        ("b", "b", b_checkpoint_state(rng), [], FamilyBConfig(), CLIP_B,
         EXPORT_BUCKETS, {"memory_min_cosine"}),
        ("b_attn", "b", model.state_dict(), attn_args, attn, ATTN_CLIP,
         EXPORT_BUCKETS, {"flash_forward", "memory_min_cosine"}),
        ("c", "c", Simple3DCNNDetector(seed=C_SEED).state_dict(), [],
         FamilyCConfig(), C_CLIP, EXPORT_BUCKETS, set()),
        ("a", "a", CausalPipelineDetector(FamilyAConfig(), in_channels=1,
                                          seed=A_SEED).state_dict(), [],
         FamilyAConfig(), A_CLIP, EXPORT_BUCKETS_A, set()),
        ("e", "e", BBoxVizDetector(seed=E_SEED).state_dict(), [], None, CLIP,
         EXPORT_BUCKETS, set())]


def outputs(out) -> tuple:
    """A scorer's outputs as a tuple (scores first)."""
    return out if isinstance(out, tuple) else (out,)


def median_ms(fn, x, calls: int) -> float:
    """Median host milliseconds of `calls` calls of a scorer (each returns
    numpy, so each ends with the card's work)."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn(x)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def export_case(case: tuple, rng: np.random.Generator, workdir: Path
                ) -> tuple:
    """One artefact of phase export: `cli export` on the card from a
    reference-format .pth, `load_scorer`, then at each bucket the
    artefact against the eager scorer (scores) and the eager
    `ScorerModule` (every output) within EXPORT_TOL, the kernel counts of
    the artefact's calls (the counts set to 0 just before them) equal to
    the eager scorer's on the same clips, a second call bit-identical,
    uint8 clips at the first bucket, and each bucket's median latency.
    Returns the line, the artefact's counts and the loaded scorer."""
    import contextlib

    from cvad_tpu_torch import cli
    from cvad_tpu_torch.evaluation.scoring import make_score_fn
    from cvad_tpu_torch.evaluation.serving import load_scorer, scorer_module

    name, family, state, args, cfg, clip, buckets, kernels = case
    pth, out = workdir / f"{name}.pth", workdir / f"{name}.pt2"
    torch.save({"model_state_dict": state}, pth)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli.main(["export", str(pth), "--family", family, "--out",
                       str(out), *args])
    export_s = time.perf_counter() - t0
    check(rc == 0, f"cli export of {name}: {said.getvalue()[-300:]}")
    blob = out.read_bytes()
    t0 = time.perf_counter()
    fn = load_scorer(blob)
    load_s = time.perf_counter() - t0
    check(fn.clip_shape == tuple(clip) and fn.device.type == "cuda",
          f"{name}: artefact clip {fn.clip_shape} on {fn.device}")
    eager = make_score_fn(family, state, cfg=cfg)
    module = scorer_module(family, state, cfg)
    xs = [rng.uniform(0, 1, (b,) + tuple(clip)).astype(np.float32)
          for b in buckets]
    reset_counts()
    got = [fn(x) for x in xs]
    torch.cuda.synchronize()
    launched = counts()
    reset_counts()
    ref = [eager(x) for x in xs]
    torch.cuda.synchronize()
    eager_launched = counts()
    err, again_equal = 0.0, True
    for x, g, r in zip(xs, got, ref):
        g, r = outputs(g), outputs(r)
        with torch.inference_mode(), no_tf32():
            want = outputs(module(torch.from_numpy(x).cuda()))
        check(len(g) == len(want), f"{name}: {len(g)} outputs")
        err = max(err, float(np.abs(g[0] - r[0]).max()),
                  *(float(np.abs(a.astype(np.float64)
                                 - w.cpu().numpy()).max())
                    for a, w in zip(g, want)))
        again_equal &= all(np.array_equal(a, b)
                           for a, b in zip(g, outputs(fn(x))))
    u8 = (xs[0] * 255).astype(np.uint8)
    err_u8 = float(np.abs(outputs(fn(u8))[0] - outputs(eager(u8))[0]).max())
    latency = [{"bucket": b, "ms": median_ms(fn, x, EXPORT_LAT_CALLS),
                "eager_ms": median_ms(eager, x, EXPORT_LAT_CALLS)}
               for b, x in zip(buckets, xs)]
    line = {"artefact": name, "family": family, "clip": list(clip),
            "bytes": len(blob), "export_s": export_s, "load_s": load_s,
            "max_abs_err": err, "max_abs_err_uint8": err_u8,
            "second_call_bit_identical": again_equal,
            "launches": {k: v for k, v in launched.items() if v},
            "eager_launches": {k: v for k, v in eager_launched.items() if v},
            "latency": latency}
    check(err <= EXPORT_TOL and err_u8 <= EXPORT_TOL,
          f"{name}: artefact vs eager {err}, uint8 {err_u8}")
    check(again_equal, f"{name}: a second call differs")
    check(launched == eager_launched,
          f"{name}: launches {line['launches']} vs eager "
          f"{line['eager_launches']}")
    check({k for k, v in launched.items() if v} == kernels
          and all(launched[k] >= len(buckets) for k in kernels),
          f"{name}: kernels launched {line['launches']}, expected {kernels}")
    return line, launched, fn, xs


_LOADER = r"""
import json, sys
import numpy as np
import torch
import cvad_tpu_torch.ops  # the kernels' custom ops, and nothing else
out = {}
for name, path, clips in json.loads(sys.argv[1]):
    program = torch.export.load(path)
    x = torch.from_numpy(np.load(clips)).cuda()
    c = torch.backends.cudnn
    with torch.inference_mode(), c.flags(
            enabled=c.enabled, benchmark=c.benchmark,
            deterministic=c.deterministic, allow_tf32=False):
        y = program.module()(x)
    y = y if isinstance(y, tuple) else (y,)
    np.savez(clips + ".out.npz", *[o.cpu().numpy() for o in y])
print(json.dumps({"modules": sorted(m for m in sys.modules
                                    if m.startswith("cvad_tpu_torch"))}))
"""


def start_loader(workdir: Path, scored: dict) -> tuple:
    """Start a fresh process that imports only `cvad_tpu_torch.ops`, loads
    the D and B-attention artefacts with `torch.export.load` and scores
    their first bucket (`finish_loader` reads it)."""
    jobs = []
    for name in ("d", "b_attn"):
        np.save(workdir / f"{name}_clips.npy", scored[name][1][0])
        jobs.append((name, str(workdir / f"{name}.pt2"),
                     str(workdir / f"{name}_clips.npy")))
    proc = subprocess.Popen([sys.executable, "-c", _LOADER,
                             json.dumps(jobs)], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, jobs, time.perf_counter()


def finish_loader(started: tuple, scored: dict) -> dict:
    """The ops-only loader's outputs within EXPORT_TOL of this process's,
    and no model, train or evaluation module imported there."""
    proc, jobs, t0 = started
    try:
        out, err_text = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    check(proc.returncode == 0,
          f"the ops-only loader failed: {err_text[-500:]}")
    modules = json.loads(out.strip().splitlines()[-1])["modules"]
    err = 0.0
    for name, _, clips in jobs:
        want = outputs(scored[name][0](scored[name][1][0]))
        with np.load(clips + ".out.npz") as f:
            got = [f[f"arr_{i}"] for i in range(len(f.files))]
        check(len(got) == len(want), f"loader: {name} outputs")
        err = max(err, *(float(np.abs(a - b).max())
                         for a, b in zip(got, want)))
    model_code = [m for m in modules if not m.startswith(
        ("cvad_tpu_torch.ops", "cvad_tpu_torch.runtime"))
        and m != "cvad_tpu_torch"]
    check(not model_code, f"the ops-only loader imported {model_code}")
    check(err <= EXPORT_TOL, f"the ops-only loader's scores differ: {err}")
    return {"artefacts": [j[0] for j in jobs], "modules": modules,
            "max_abs_err": err, "seconds": time.perf_counter() - t0}


def export_http(scored: dict, rng: np.random.Generator) -> list:
    """One HTTP round trip each from the A and B-attention artefacts
    (`ClipScoringService.from_exported`): scores, and family A's
    detections as "graphs", within EXPORT_TOL of the direct scorer."""
    from cvad_tpu_torch.evaluation.http_service import ScoringHTTPServer
    from cvad_tpu_torch.evaluation.serving import ClipScoringService

    out = []
    for name in ("a", "b_attn"):
        fn = scored[name][0]
        srv = ScoringHTTPServer(ClipScoringService(
            fn, buckets=(1, 4), clip_shape=fn.clip_shape), port=0)
        host, port = srv.start()
        try:
            x = rng.uniform(0, 1, (3,) + fn.clip_shape).astype(np.float32)
            t0 = time.perf_counter()
            rep = post(f"http://{host}:{port}/score", npz(x),
                       "application/octet-stream")
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            srv.close()
        direct = outputs(fn(x))
        err = float(np.abs(np.asarray(rep["scores"]) - direct[0]).max())
        if name == "a":
            err = max(err, float(np.abs(np.asarray(rep["graphs"])
                                        - direct[1]).max()))
        else:
            check(rep["graphs"] is None, "family B replied graphs")
        check(set(rep) == {"scores", "graphs", "n"} and rep["n"] == 3
              and err <= EXPORT_TOL, f"HTTP {name}: {err}, keys {set(rep)}")
        out.append({"artefact": name, "clips": 3, "ms": ms,
                    "max_abs_err": err})
    return out


def export_serve(workdir: Path, scored: dict) -> dict:
    """`cli serve D.pt2 --probe-timeout 120` in its own process: the device
    probe passes, the server answers /healthz at the artefact's clip shape
    and scores 8 clips within EXPORT_TOL of the direct scorer; then it is
    stopped."""
    import select

    fn, xs = scored["d"]
    x = xs[1]
    t0 = time.perf_counter()
    errors = workdir / "serve.err"
    with open(errors, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cvad_tpu_torch.cli", "serve",
             str(workdir / "d.pt2"), "--port", "0", "--probe-timeout", "120"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err_file, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 300)
        said = proc.stdout.readline() if ready else ""
        check(said.startswith("{"), f"cli serve said {said!r}, exit "
                                    f"{proc.poll()}: "
                                    f"{errors.read_text()[-500:]}")
        started = json.loads(said)
        check("port" in started, f"cli serve said {started}")
        base = f"http://{started['host']}:{started['port']}"
        health = get(base + "/healthz")
        rep = post(base + "/score", npz(x), "application/octet-stream")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    err = float(np.abs(np.asarray(rep["scores"]) - fn(x)[0]).max())
    check(tuple(health["clip_shape"]) == CLIP and err <= EXPORT_TOL,
          f"cli serve: clip {health['clip_shape']}, error {err}")
    return {"device": started.get("device"), "clip_shape": health[
        "clip_shape"], "clips": len(x), "max_abs_err": err,
        "seconds": time.perf_counter() - t0}


def phase_export(card: str) -> dict:
    """Phase export (see the module docstring); returns the launch counts
    of each artefact's calls (paths export_<artefact>)."""
    rng = np.random.default_rng(EXPORT_SEED)
    t_start = time.perf_counter()
    paths, scored, lines = {}, {}, []
    with tempfile.TemporaryDirectory(prefix="cvad_export_") as tmp:
        workdir = Path(tmp)
        for case in export_cases(rng):
            line, launched, fn, xs = export_case(case, rng, workdir)
            emit({"phase": "export", **line})
            lines.append(line)
            paths[f"export_{line['artefact']}"] = launched
            scored[line["artefact"]] = (fn, xs)
            torch.cuda.empty_cache()
        started = start_loader(workdir, scored)  # runs beside the next two
        try:
            http = export_http(scored, rng)
            serve = export_serve(workdir, scored)
        finally:
            loader = finish_loader(started, scored)
    emit({"phase": "export_summary", "card": card, "loader": loader,
          "http": http, "serve": serve,
          "export_s": {ln["artefact"]: ln["export_s"] for ln in lines},
          "load_s": {ln["artefact"]: ln["load_s"] for ln in lines},
          "seconds": time.perf_counter() - t_start})
    return paths


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """Every ``nn.Dropout`` of `model` at p = 0: the card's and the CPU's
    generators draw different masks."""
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return model


class SharedDraws:
    """Family A's VAE draw (`models/family_a.py::vae_noise`) from a CPU
    generator seeded with `seed` plus the draw's number, moved to the
    device: a card run and a CPU run take the same draws.  A context
    manager that puts itself in place of `vae_noise` and restores it."""

    def __init__(self, seed: int):
        self.seed, self.calls, self.saved = seed, 0, None

    def __call__(self, shape, dtype, device, generator):
        gen = torch.Generator().manual_seed(self.seed + self.calls)
        self.calls += 1
        return torch.randn(shape, generator=gen).to(device, dtype)

    def __enter__(self):
        import cvad_tpu_torch.models.family_a as family_a

        self.saved = family_a.vae_noise
        family_a.vae_noise = self
        return self

    def __exit__(self, *exc):
        import cvad_tpu_torch.models.family_a as family_a

        family_a.vae_noise = self.saved


def c_config(batch: int, **train):
    """The mini3d preset at C_CLIP (its own clip), uint8 transfer."""
    from cvad_tpu_torch.config import preset

    cfg = preset("mini3d")
    return cfg.replace(
        data=cfg.data.replace(batch_size=batch, transfer_dtype="uint8",
                              clip_len=C_CLIP[0], frame_size=C_CLIP[1:3]),
        train=cfg.train.replace(log_every=10**9, **train))


def a_config(batch: int, name: str = "causal_pipeline", **train):
    """Family A's preset `name` at A_CLIP (its own clip), uint8
    transfer."""
    from cvad_tpu_torch.config import preset

    cfg = preset(name)
    return cfg.replace(
        data=cfg.data.replace(batch_size=batch, transfer_dtype="uint8",
                              clip_len=A_CLIP[0], frame_size=A_CLIP[1:3]),
        train=cfg.train.replace(log_every=10**9, **train))


def box_margin(out: dict) -> float:
    """The smallest distance (pixels) of a masked detector's box coordinate
    from a validity threshold (x in [10, 350], y in [10, 230]; w and h lie
    inside theirs by construction)."""
    det = out["detections"].detach().double().cpu()
    x, y = det[..., 0], det[..., 1]
    return float(torch.stack([(x - 10).abs(), (x - 350).abs(),
                              (y - 10).abs(), (y - 230).abs()]).min())


def steps_on(cfg, batches: list, state: Optional[dict], dev: str) -> tuple:
    """`cfg`'s float32 train steps over numpy `batches` on `dev` from the
    seed-0 init (or the model state dict `state`), dropout off, family A's
    VAE draws shared (`SharedDraws`): (metrics, the train state, the
    launches by kernel, the train state before each step as
    `TrainState.state_dict()`)."""
    from cvad_tpu_torch.train.state import float_metrics
    from cvad_tpu_torch.train.tasks import build_task

    task = build_task(cfg)
    st = task.init_state(0, dev)
    if state is not None:
        st.model.load_state_dict(state, strict=True)
    no_dropout(st.model)
    before, metrics, states = counts(), [], []
    with SharedDraws(A_NOISE_SEED):
        for b in batches:
            states.append(st.state_dict())
            st, m = task.train_step(
                st, {k: torch.from_numpy(v).to(dev) for k, v in b.items()}, 1)
            metrics.append(float_metrics(m))
    rose = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    return metrics, st, rose, states


def pinned_step(cfg, before: dict, batch: dict, k: int, dev: str,
                pins: tuple) -> tuple:
    """Step `k` (from 0) of `cfg` on `dev` from the train state `before`
    (`TrainState.state_dict()`) on numpy `batch`: `train/tasks.py`'s step,
    dropout off, the k-th VAE draw of `SharedDraws`, every ReLU mask and
    max-pool argmax replayed from `pins` (`Relus`, `Pools` recordings):
    (metrics, the model state dict on the CPU, the gradient as Adam took it
    (from its first moment) by trainable parameter, the launches by
    kernel)."""
    from cvad_tpu_torch.train.state import float_metrics
    from cvad_tpu_torch.train.tasks import build_task

    task = build_task(cfg)
    st = task.init_state(0, dev)
    st.load_state_dict(before)
    no_dropout(st.model)
    mu, start = st.opt_state.mu.clone(), counts()
    with SharedDraws(A_NOISE_SEED + k), Relus(pins[0]), Pools(pins[1]):
        st, m = task.train_step(
            st, {n: torch.from_numpy(v).to(dev) for n, v in batch.items()}, 1)
    rose = {n: v - start[n] for n, v in counts().items() if v != start[n]}
    b1 = cfg.optim.b1
    g = ((st.opt_state.mu - b1 * mu) / (1 - b1)).cpu()
    named = [(n, p.numel()) for n, p in st.model.named_parameters()
             if p.requires_grad]
    grads = dict(zip((n for n, _ in named), g.split([k for _, k in named])))
    return (float_metrics(m),
            {n: v.cpu() for n, v in st.model.state_dict().items()},
            grads, rose)


def step_readings(cpu: tuple, card: tuple,
                  tiny_rel: float = STEP_TINY_REL) -> dict:
    """One pinned step from the same train state on the CPU and on the
    card (`pinned_step`'s results): the metrics' largest relative
    difference; the gradients' (each leaf's largest difference over the
    CPU's largest entry); the parameters' largest difference, over all
    entries and over the steady ones (CPU gradient above `tiny_rel` of its
    leaf's largest |entry|); the share beyond STEP_PARAM_ATOL (and the four
    worst leaves) and, among those entries, the largest |gradient| over
    its leaf's largest; the running statistics' largest difference over
    each leaf's largest entry."""
    (mc, pc, gc, _), (mg, pg, gg, rose) = cpu, card
    d, steady, far, hi = [], [], {}, 0.0
    for n, g in gc.items():
        r = (g.abs() / max(float(g.abs().max()), 1e-30)).reshape(-1)
        e = (pg[n] - pc[n]).abs().reshape(-1)
        d.append(e)
        steady.append(r > tiny_rel)
        far[n] = float((e > STEP_PARAM_ATOL).double().mean())
        if bool((e > STEP_PARAM_ATOL).any()):
            hi = max(hi, float(r[e > STEP_PARAM_ATOL].max()))
    d, steady = torch.cat(d), torch.cat(steady)
    return {"loss_cpu": mc["loss"], "loss_card": mg["loss"],
            "metrics_max_rel_err": max(abs(mg[k] - mc[k])
                                       / max(abs(mc[k]), 1e-6) for k in mc),
            "grad_max_rel_err": max(rel_errs(gg, gc).values()),
            "params_max_abs_err": float(d.max()),
            "params_steady_share": float(steady.double().mean()),
            "params_steady_max_abs_err": float(d[steady].max()),
            "params_beyond_atol_share": float((d > STEP_PARAM_ATOL)
                                              .double().mean()),
            "params_beyond_atol_worst_leaves": {
                n: far[n] for n in sorted(far, key=far.get,
                                          reverse=True)[:4]},
            "params_beyond_atol_max_grad_rel": hi,
            "stats_max_rel_err": max(
                float((pg[k] - pc[k]).abs().max() / pc[k].abs().max())
                for k in pc if "running" in k),
            "card_launches": rose}


def step_holds(r: dict, lr: float) -> bool:
    """`step_readings` within the module's limits."""
    return (not r["card_launches"]
            and r["metrics_max_rel_err"] <= STEP_RTOL
            and r["params_steady_max_abs_err"] <= STEP_PARAM_ATOL
            and r["params_max_abs_err"] <= 2 * lr
            and r["params_beyond_atol_share"] <= STEP_FAR_SHARE
            and r["stats_max_rel_err"] <= STEP_STATS_REL)


def box_shares(cfg, before: dict, batch: dict, k: int) -> dict:
    """Family A's train-mode detections at the train state `before` on
    numpy `batch` (the k-th VAE draw) on the card, each box held to
    A_MARGIN: the valid box and trajectory shares."""
    from cvad_tpu_torch.train.tasks import build_task, prep_frames

    model = build_task(cfg).init_state(0, "cuda").model
    model.load_state_dict(before["model_state_dict"], strict=True)
    with torch.no_grad(), no_tf32(), SharedDraws(A_NOISE_SEED + k):
        out = no_dropout(model).train()(
            prep_frames(torch.from_numpy(batch["clips"]).cuda()))
    check(box_margin(out) > A_MARGIN,
          f"a box lies {box_margin(out)} px from a threshold")
    return {"valid_box": float(out["detection_mask"].float().mean()),
            "valid_trajectory": float(out["trajectory_mask"].float().mean())}


def step_parity(cfg, batches: list, state: Optional[dict],
                probe: bool = False, sweep: tuple = (),
                checked: bool = True) -> dict:
    """PARITY_STEPS float32 steps of `cfg` from `state` (the seed-0 init
    where None), card against CPU step by step.  The CPU's own run gives
    the train state before each step; from it, on that step's batch: the
    gradient rule (`grad_readings`: card and CPU float32 against the CPU's
    float64, every ReLU mask and max-pool argmax pinned to float64's), and
    one train step on the CPU and on the card with those decisions pinned
    (`pinned_step`), compared by `step_readings` (also at the steady-entry
    thresholds `sweep`) and held to `step_holds` unless `checked` is
    False.  With `probe` (family A), the card's detections at each step's
    state are held to A_MARGIN (`box_shares`).  Returns the readings by
    step."""
    cpu_metrics, _, cpu_rose, befores = steps_on(cfg, batches, state, "cpu")
    check(not cpu_rose, f"the CPU steps launched a port kernel: {cpu_rose}")
    steps = []
    for k, (before, batch) in enumerate(zip(befores, batches)):
        step = {"box_shares": box_shares(cfg, before, batch, k)} if probe \
            else {}
        grad, pins = grad_readings(cfg, batch, before["model_state_dict"], k)
        cpu = pinned_step(cfg, before, batch, k, "cpu", pins)
        card = pinned_step(cfg, before, batch, k, "cuda", pins)
        step.update(step_readings(cpu, card), grad=grad,
                    loss_unpinned_cpu=cpu_metrics[k]["loss"])
        if sweep:
            step["by_tiny_rel"] = {str(t): step_readings(cpu, card, t)
                                   for t in sweep}
        steps.append(step)
        if checked:
            check(grad["holds"], f"step {k}'s gradient vs float64: {grad}")
            check(step_holds(step, cfg.optim.lr),
                  f"card vs CPU step {k} differs: {step}")
    return {"steps": steps}


def loss_grads(cfg, model: torch.nn.Module, batch: dict,
               dtype: torch.dtype, draw: int = 0) -> dict:
    """The gradient of one train step of family C or A (`cfg`) at `model`'s
    parameters on a numpy `batch`, in `dtype` (a float64 copy of the model
    for float64): `train/tasks.py`'s step up to its gradients, on a copy of
    the model (its running statistics untouched), the `draw`-th VAE draw
    of `SharedDraws`; returned on the CPU by trainable parameter name."""
    from cvad_tpu_torch.config import FamilyAConfig
    from cvad_tpu_torch.ops.losses import binary_cross_entropy, family_a_loss
    from cvad_tpu_torch.train.tasks import (card_numerics, prep_clips,
                                            prep_frames,
                                            stop_bn_absorbed_biases)

    dev = next(model.parameters()).device
    m = copy.deepcopy(model).to(dtype).train()
    clips = torch.from_numpy(batch["clips"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)
    family_a = isinstance(cfg.model, FamilyAConfig)
    x = (prep_frames if family_a else prep_clips)(clips).to(dtype)
    with card_numerics(), SharedDraws(A_NOISE_SEED + draw):
        out = m(x)
        if family_a:
            loss, _ = family_a_loss(out, labels, cfg.loss)
        else:
            loss = binary_cross_entropy(out.reshape(-1),
                                        labels.to(dtype)).mean()
        grads = stop_bn_absorbed_biases(m, loss)
    names = [n for n, p in m.named_parameters() if p.requires_grad]
    return {n: g.detach().cpu() for n, g in zip(names, grads)}


def grad_readings(cfg, batch: dict, state: Optional[dict] = None,
                  draw: int = 0) -> tuple:
    """A step's gradient from the seed-0 init (or the model state dict
    `state`) on `batch` (the `draw`-th VAE draw), the card's
    float32, the CPU's float32 and the CPU's float64, every ReLU's mask and
    every max pool's argmax pinned to the float64 forward's (`Relus`,
    `Pools`: a decision that float32 rounding flips is not arithmetic).
    By leaf, each a largest difference over float64's largest entry:
    e_card and e_cpu, each against float64; e_diff, card against CPU.
    Every leaf's e_card within GRAD_F64_REL + GRAD_KAPPA * e_cpu, as
    long_train_parity's rule with its own absolute term (where float32
    itself cancels, as in family C's head bias at init, the CPU's own error
    widens the bound).  Returns the leaf with the largest share of
    its bound and whether every leaf holds, and the float64 forward's
    decisions (the ReLU masks, the max-pool argmaxes)."""
    from cvad_tpu_torch.train.tasks import build_task

    task = build_task(cfg)
    cpu, card = (no_dropout(task.init_state(0, dev).model)
                 for dev in ("cpu", "cuda"))
    if state is not None:
        cpu.load_state_dict(state, strict=True)
        card.load_state_dict(state, strict=True)
    with Relus() as ref, Pools() as pools:
        g64 = loss_grads(cfg, cpu, batch, torch.float64, draw)
    with Relus(ref.masks), Pools(pools.indices):
        g32 = loss_grads(cfg, cpu, batch, torch.float32, draw)
    with Relus(ref.masks), Pools(pools.indices):
        got = loss_grads(cfg, card, batch, torch.float32, draw)
    e_card, e_cpu = rel_errs(got, g64), rel_errs(g32, g64)
    e_diff = {n: (got[n].double() - g32[n].double()).abs().max().item()
              / max(g.abs().max().item(), 1e-30) for n, g in g64.items()}
    share = {n: e_card[n] / (GRAD_F64_REL + GRAD_KAPPA * e_cpu[n])
             for n in g64}
    name = max(share, key=share.get)
    out = {"relus": len(ref.masks), "max_pools": len(pools.indices),
           "worst_leaf": {"leaf": name, "e_card": e_card[name],
                          "e_cpu": e_cpu[name], "e_diff": e_diff[name],
                          "share_of_bound": share[name]},
           "e_card_max": max(e_card.values()),
           "e_cpu_max": max(e_cpu.values()),
           "holds": max(share.values()) <= 1.0}
    return out, (ref.masks, pools.indices)


def same_state(a, b) -> bool:
    """Two train states bit-identical: every state-dict entry and Adam."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(getattr(a.opt_state, k),
                                getattr(b.opt_state, k))
                    for k in ("mu", "nu", "count")))


def fit_and_resume(cfg, workdir: Path, name: str, train_clips: int,
                   eval_clips: int) -> dict:
    """`Trainer.fit` on synthetic clips for cfg's epochs, then a run of one
    epoch fewer resumed from its last epoch's checkpoint and finished: the
    launch counts over the fits, the seconds, the history, the eval of the
    best checkpoint, and whether the resumed run equals the uninterrupted
    one bit for bit (weights, BatchNorm statistics, Adam, history)."""
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.data.datasets import build_dataset
    from cvad_tpu_torch.train.engine import Trainer

    batch = cfg.data.batch_size
    t0 = time.perf_counter()
    train_loader = BatchLoader(build_dataset(cfg.data, "Train", train_clips),
                               batch, shuffle=True, seed=cfg.data.seed,
                               transfer_dtype="uint8")
    eval_loader = BatchLoader(build_dataset(cfg.data, "Test", eval_clips),
                              batch, transfer_dtype="uint8")
    data_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    full = Trainer(cfg, out_dir=str(workdir / f"{name}_full"))
    hist = full.fit(train_loader, eval_loader)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    epochs = cfg.train.num_epochs
    first = Trainer(cfg.replace(train=cfg.train.replace(
        num_epochs=epochs - 1)), out_dir=str(workdir / f"{name}_resumed"))
    first.fit(train_loader, eval_loader)
    resumed = Trainer(cfg, out_dir=str(workdir / f"{name}_resumed"))
    restored = resumed.restore()
    resumed.fit(train_loader, eval_loader)
    best = Trainer(cfg, out_dir=str(workdir / f"{name}_ref"))
    best.init_state()
    best.state.load_state_dict(full.ckpt.restore("best"))
    evaluated = best.evaluate(eval_loader)
    torch.cuda.synchronize()
    launches = counts()
    return {"launches": launches, "data_s": data_s, "fit_s": fit_s,
            "hist": hist, "restored": restored, "evaluated": evaluated,
            "best": best,
            "bit_identical": (same_state(full.state, resumed.state)
                              and full.history.as_dict()
                              == resumed.history.as_dict()),
            "full": full, "eval_loader": eval_loader,
            "steps": 2 * epochs * (train_clips // batch)}


def best_scorer_err(family: str, fit: dict) -> tuple:
    """The best checkpoint's ``.pth`` through ``make_score_fn(family)`` on
    16 eval clips, against the eval step of a trainer holding it: (the
    scores, the largest difference)."""
    from cvad_tpu_torch.evaluation.scoring import make_score_fn
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

    clips = np.stack([fit["eval_loader"].dataset[i][0]
                      for i in range(min(16, len(fit["eval_loader"].dataset)))])
    cfg = fit["full"].cfg.model
    scores = make_score_fn(family, load_torch_state_dict(
        str(fit["full"].ckpt.path("best"))), cfg=cfg)(clips)
    ref = fit["best"]
    want = ref.task.eval_step(ref.state, ref.put_batch(
        {"clips": clips, "labels": np.zeros(len(clips), np.float32)}))
    err = float(np.abs(scores - want["predictions"].cpu().numpy()).max())
    check(scores.shape == (len(clips),) and bool(np.isfinite(scores).all())
          and err <= 1e-5, f"family {family}'s best checkpoint scorer vs "
                           f"its eval step: {err}")
    return scores, err


def c_step_batches(rng: np.random.Generator) -> list:
    """Family C's PARITY_STEPS batches of uint8 clips and 0/1 labels."""
    return [{"clips": rng.integers(0, 256, (C_BATCH,) + C_CLIP,
                                   dtype=np.uint8),
             "labels": (rng.uniform(size=C_BATCH) < 0.5).astype(np.float32)}
            for _ in range(PARITY_STEPS)]


def phase_family_c(workdir: Path, card: str) -> dict:
    """Family C (the mini3d preset) on the card: the scorer against the
    CPU's from the same weights; 3 float32 train steps card vs CPU, step
    by step (`step_parity`); `Trainer.fit` with eval (auc), a checkpoint an epoch and a resume
    bit-identical on the card; the best checkpoint's scorer against the
    eval step; step times.  No port kernel runs (cuDNN convs, as
    `cvad_tpu` runs XLA's).  Returns the fit's launch counts."""
    from cvad_tpu_torch.evaluation.scoring import make_score_fn
    from cvad_tpu_torch.models import Simple3DCNNDetector
    from cvad_tpu_torch.train.state import param_count

    rng = np.random.default_rng(C_SEED)
    state = Simple3DCNNDetector(seed=0).state_dict()
    clips = rng.uniform(0, 1, (64,) + C_CLIP).astype(np.float32)
    before = counts()
    s_gpu = make_score_fn("c", state)(clips)
    launched = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
    s_cpu = make_score_fn("c", state, device="cpu")(clips)
    score_err = float(np.abs(s_gpu - s_cpu).max())
    check(s_gpu.shape == (64,) and bool(np.isfinite(s_gpu).all())
          and score_err <= 1e-5 and not launched,
          f"family C scorer: err {score_err}, launches {launched}")

    cfg = c_config(C_BATCH)
    batches = c_step_batches(rng)
    parity = step_parity(cfg, batches, None)

    fit = fit_and_resume(c_config(C_BATCH, num_epochs=2, eval_every=1,
                                  save_interval=1), workdir, "c",
                         C_TRAIN_CLIPS, C_EVAL_CLIPS)
    full, hist = fit["full"], fit["hist"]
    best_scores, best_err = best_scorer_err("c", fit)
    times = [train_step_times(rng, dtype, "c")
             for dtype in ("float32", "bfloat16")]
    n_params = param_count(full.state.model)
    emit({"phase": "family_c", "card": card, "params": n_params,
          "clip": list(C_CLIP), "batch": C_BATCH,
          "scorer": {"clips": len(clips), "max_abs_err_vs_cpu": score_err},
          "parity": parity,
          "fit": {"train_clips": C_TRAIN_CLIPS, "eval_clips": C_EVAL_CLIPS,
                  "epochs": 2, "train_steps": fit["steps"],
                  "synthetic_data_s": fit["data_s"], "fit_s": fit["fit_s"],
                  "train_losses": hist["train_losses"],
                  "auc": [e["auc"] for e in hist["evaluation_metrics"]],
                  "resumed_from_epoch": fit["restored"],
                  "resume_bit_identical": fit["bit_identical"],
                  "best_checkpoint_score_err": best_err,
                  "best_score_mean": float(best_scores.mean())},
          "step_times": times, "launches": fit["launches"]})
    check(n_params == C_PARAMS, f"{n_params} family-C parameters")
    check(all(np.isfinite(hist["train_losses"])), "family C train history")
    check(fit["restored"] == 1 and fit["bit_identical"],
          "the resumed family-C run differs from the uninterrupted one")
    check(not any(fit["launches"].values()),
          f"family C's fit launched {fit['launches']}")
    return fit["launches"]


def a_clips(rng: np.random.Generator, b: int) -> np.ndarray:
    """(b, 16, 240, 360, 1) uint8 clips, each frame at its own brightness,
    so that the backbone's features differ from frame to frame."""
    gain = rng.uniform(0.1, 1.0, (b, A_CLIP[0], 1, 1, 1))
    return (rng.integers(0, 256, (b,) + A_CLIP) * gain).astype(np.uint8)


def mixed_head(state: dict, frames: list, train: bool = False) -> dict:
    """A copy of family-A `state` whose detector head varies validity by
    frame and slot: each slot's x row scaled to unit spread over the
    batches `frames` (the CPU's eval forward, or with `train` the train-mode
    one, batch statistics and dropout off), its bias putting the threshold
    x = 350 in the widest gap of the middle half of those values; the y, w
    and h rows zero (the box centre, valid)."""
    from cvad_tpu_torch.models import CausalPipelineDetector

    m = CausalPipelineDetector()
    m.load_state_dict(state, strict=True)
    m.eval().backbone.train(train)
    with torch.no_grad():
        h = torch.cat([m.detector.detector_net[:10](m.backbone(f))
                       for f in frames])
    key = "detector.detector_net.10"
    w = torch.zeros_like(state[f"{key}.weight"])
    bias = torch.zeros_like(state[f"{key}.bias"])
    for k in range(w.shape[0] // 4):
        row = state[f"{key}.weight"][4 * k]
        raw = (h @ row).reshape(-1).double()
        row = row / float(raw.std())
        v = torch.sort(raw / float(raw.std())).values
        mid = v[len(v) // 4: 3 * len(v) // 4 + 1]
        i = int(torch.argmax(mid[1:] - mid[:-1]))
        w[4 * k] = row
        bias[4 * k] = math.log(350 / 10) - float(mid[i] + mid[i + 1]) / 2
    return {**state, f"{key}.weight": w, f"{key}.bias": bias}


def a_step_batches(rng: np.random.Generator) -> list:
    """Family A's PARITY_STEPS batches (`a_clips`, labels 0, 1, 0, 1)."""
    return [{"clips": a_clips(rng, A_BATCH),
             "labels": (np.arange(A_BATCH) % 2).astype(np.float32)}
            for _ in range(PARITY_STEPS)]


def a_step_head(state: dict, batches: list) -> dict:
    """`mixed_head` of family-A `state` placed on the train-mode features
    of the steps' `batches`."""
    from cvad_tpu_torch.train.tasks import prep_frames

    return mixed_head(state, [prep_frames(torch.from_numpy(b["clips"]))
                              for b in batches], train=True)


def a_forward_parity(state: dict, clips: np.ndarray) -> dict:
    """Family A's eval forward of `state` on the card and on the CPU, TF32
    off: every output's largest difference, the masks equal, each side's
    box margin above A_MARGIN."""
    from cvad_tpu_torch.models import CausalPipelineDetector
    from cvad_tpu_torch.train.tasks import prep_frames

    outs = {}
    for dev in ("cuda", "cpu"):
        m = CausalPipelineDetector()
        m.load_state_dict(state, strict=True)
        m = m.to(dev).eval()
        with torch.no_grad(), no_tf32():
            out = m(prep_frames(torch.from_numpy(clips).to(dev)))
        outs[dev] = {k: v.detach().cpu() for k, v in out.items()}
        check(box_margin(out) > A_MARGIN,
              f"a box lies {box_margin(out)} px from a threshold on {dev}")
    g, c = outs["cuda"], outs["cpu"]
    for k in ("detection_mask", "trajectory_mask"):
        check(torch.equal(g[k], c[k]), f"family A's {k} differs on the card")
    errs = {k: float((g[k].double() - c[k].double()).abs().max())
            for k in g if k not in ("detection_mask", "trajectory_mask")}
    out = {"max_abs_err": errs, "box_margin_px": box_margin(c),
           "valid_box_share": float(c["detection_mask"].float().mean()),
           "valid_trajectory_share": float(
               c["trajectory_mask"].float().mean()),
           "adjacency_max": float(c["adjacency_matrices"].max()),
           "score_mean": float(c["anomaly_scores"].mean())}
    check(all(v <= (1e-2 if k == "detections" else 1e-4)
              for k, v in errs.items()),
          f"family A card vs CPU forward: {out}")
    return out


def phase_family_a(workdir: Path, card: str) -> tuple:
    """Family A (the causal_pipeline preset) at full width on the card:
    the eval forward card vs CPU (scores, adjacency, detections, both
    masks), from the preset's initialisation and from a head whose boxes
    cross the thresholds; from such a head (placed on the steps' batches),
    3 float32 train steps card vs CPU step by step (`step_parity`), the bf16
    step against the f32 step,
    and 3 remat steps bit-identical to the plain ones on the card, running
    statistics included; one step of causal_pipeline_v0; `Trainer.fit` with eval (val_acc, analysis) and a resume
    bit-identical on the card; step times.  No port kernel runs (cuDNN
    convs, as `cvad_tpu` runs XLA's).  Returns the fit's launch counts and
    the best checkpoint's state dict."""
    from cvad_tpu_torch.models import CausalPipelineDetector
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.train.state import param_count
    from cvad_tpu_torch.train.tasks import prep_frames

    rng = np.random.default_rng(A_SEED)
    init = CausalPipelineDetector(seed=0).state_dict()
    clips = a_clips(rng, A_BATCH)
    before = counts()
    forward = {"preset_init": a_forward_parity(init, clips)}
    forward["mixed_head"] = a_forward_parity(
        mixed_head(init, [prep_frames(torch.from_numpy(clips))]), clips)
    check(0 < forward["mixed_head"]["valid_box_share"] < 1
          and forward["mixed_head"]["adjacency_max"] > 0,
          f"the mixed head's masks do not vary: {forward['mixed_head']}")

    cfg = a_config(A_BATCH)
    batches = a_step_batches(rng)
    # the steps start from a head whose boxes cross the thresholds, so the
    # tracker, GRU and VAE see valid and invalid boxes
    mixed = a_step_head(init, batches)
    parity = step_parity(cfg, batches, mixed, probe=True)
    shares = [st["box_shares"] for st in parity["steps"]]
    check(all(0 < sh["valid_box"] < 1 for sh in shares),
          f"the steps' box masks do not vary: {shares}")
    on_card = steps_on(cfg, batches, mixed, "cuda")
    bf16 = steps_on(a_config(A_BATCH, dtype="bfloat16"), batches[:1], mixed,
                    "cuda")
    bf16_err = abs(bf16[0][0]["loss"] - on_card[0][0]["loss"]) / on_card[0][0][
        "loss"]
    check(np.isfinite(bf16[0][0]["loss"]) and bf16_err <= A_BF16_RTOL,
          f"family A's bf16 step loss {bf16[0][0]} vs f32 {on_card[0][0]}")
    anchor = steps_on(a_config(A_BATCH, "causal_pipeline_v0"), batches[:1],
                      None, "cuda")
    am = anchor[0][0]
    check(np.isfinite(am["loss"])
          and abs(am["loss"] - am["score_mse"] - 1e-3 * am["kl"])
          <= 1e-5 * am["loss"],
          f"causal_pipeline_v0's step: {am}")
    remat_cfg = cfg.replace(model=cfg.model.replace(remat=True))
    remat = steps_on(remat_cfg, batches, mixed, "cuda")
    remat_same = same_state(remat[1], on_card[1])
    check(remat_same, "the remat steps differ from the plain ones")
    launched = {k: v - before[k] for k, v in counts().items()
                if v != before[k]}
    check(not launched, f"family A's checks launched {launched}")

    fit_cfg = a_config(A_BATCH, num_epochs=2, eval_every=1, save_interval=1)
    fit_cfg = fit_cfg.replace(optim=fit_cfg.optim.replace(cosine_steps=2))
    fit = fit_and_resume(fit_cfg, workdir, "a", A_TRAIN_CLIPS, A_EVAL_CLIPS)
    full, hist, evaluated = fit["full"], fit["hist"], fit["evaluated"]
    best_scores, best_err = best_scorer_err("a", fit)
    times = [train_step_times(rng, dtype, fam) for fam, dtype in (
        ("a", "float32"), ("a", "bfloat16"), ("a_anchor", "float32"))]
    n_params = param_count(full.state.model)
    emit({"phase": "family_a", "card": card, "params": n_params,
          "trainable_params": sum(p.numel() for p in full.state.params()),
          "anchor_params": param_count(anchor[1].model),
          "clip": list(A_CLIP), "batch": A_BATCH,
          "channels": list(cfg.model.backbone_channels),
          "forward": forward, "parity": parity,
          "bf16_step": {"loss_bf16": bf16[0][0]["loss"],
                        "loss_f32": on_card[0][0]["loss"],
                        "loss_rel_err": bf16_err},
          "anchor_step": am, "remat_bit_identical": remat_same,
          "fit": {"train_clips": A_TRAIN_CLIPS, "eval_clips": A_EVAL_CLIPS,
                  "epochs": 2, "train_steps": fit["steps"],
                  "synthetic_data_s": fit["data_s"], "fit_s": fit["fit_s"],
                  "train_losses": hist["train_losses"],
                  "val_acc": [e["val_acc"]
                              for e in hist["evaluation_metrics"]],
                  "analysis": {k: v for k, v in evaluated["analysis"].items()
                               if k != "samples"},
                  "resumed_from_epoch": fit["restored"],
                  "resume_bit_identical": fit["bit_identical"],
                  "best_checkpoint_score_err": best_err,
                  "best_score_mean": float(best_scores.mean())},
          "step_times": times, "launches": fit["launches"]})
    check(n_params == A_PARAMS and param_count(anchor[1].model)
          == A_ANCHOR_PARAMS, f"family A parameters: {n_params}")
    check(all(np.isfinite(hist["train_losses"]))
          and evaluated["analysis"]["total_samples"] == A_EVAL_CLIPS
          and "val_acc" in hist["evaluation_metrics"][0],
          "family A train history and eval")
    check(fit["restored"] == 1 and fit["bit_identical"],
          "the resumed family-A run differs from the uninterrupted one")
    check(not any(fit["launches"].values()),
          f"family A's fit launched {fit['launches']}")
    return fit["launches"], load_torch_state_dict(
        str(full.ckpt.path("best")))


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


def step_config(family: str, dtype: str) -> tuple:
    """(config, batch size, clip) of a train-step path: 'd' family D at
    B=256, T=8; 'b' family B (LSTM) at B=256; 'd64' the long-window step
    at T=64, B=128, conv1 on K5; 'd64_k1' the same step with the default
    lowering, conv1 on K1 (its backward the whole-T folded conv's);
    'b_attn' family B with the attention encoder at B=16, T=128 (attention
    on K6, in float32 at either dtype, as in `cvad_tpu`); 'c' family C
    (mini3d, B=8); 'a' and 'a_anchor' family A at full width (B=4, 16 x 240
    x 360), the causal_pipeline and causal_pipeline_v0 presets; 'a_remat'
    causal_pipeline with the backbone rematerialised."""
    if family == "b":
        return b_train_config(TRAIN_BATCH, dtype=dtype), TRAIN_BATCH, CLIP_B
    if family == "b_attn":
        return attn_config(ATTN_BATCH, dtype=dtype), ATTN_BATCH, ATTN_CLIP
    if family == "c":
        return c_config(C_BATCH, dtype=dtype), C_BATCH, C_CLIP
    if family in ("a", "a_anchor", "a_remat"):
        cfg = a_config(A_BATCH, "causal_pipeline_v0" if family == "a_anchor"
                       else "causal_pipeline", dtype=dtype)
        if family == "a_remat":
            cfg = cfg.replace(model=cfg.model.replace(remat=True))
        return cfg, A_BATCH, A_CLIP
    if family in ("d64", "d64_k1"):
        cfg = long_config(LONG_BATCH, dtype=dtype)
        if family == "d64_k1":
            cfg = cfg.replace(model=cfg.model.replace(conv_group_impl="stack"))
        return cfg, LONG_BATCH, LONG_CLIP
    return train_config(TRAIN_BATCH, dtype=dtype), TRAIN_BATCH, CLIP


def step_batches(rng: np.random.Generator, n: int, batch_size: int,
                 clip: tuple) -> list:
    """`n` train batches on the card as the engine feeds them: uint8
    clips, labels normal at the train split's rate, the valid mask."""
    return [{"clips": torch.from_numpy(rng.integers(
        0, 256, (batch_size,) + clip, dtype=np.uint8)).cuda(),
        "labels": torch.from_numpy((rng.uniform(size=batch_size)
                                    < B_ANOMALY_RATE).astype(np.float32))
        .cuda(),
        "valid": torch.ones(batch_size, device="cuda")} for _ in range(n)]


def train_step_times(rng: np.random.Generator, dtype: str,
                     family: str = "d", k: int = 1) -> dict:
    """The train step of a path (`step_config`) from uint8 clips already on
    the card: CUDA events around each of SPC_CALLS calls after warm-up
    calls, a call one eager step (k = 1) or one replay of a captured
    graph of k steps on k copies of the batch (`train/graphs.py`), with
    the chunk's copy into the graph's buffers; times per optimizer step,
    device time by kernel over one call (torch.profiler)."""
    from cvad_tpu_torch.train.graphs import StepGraph
    from cvad_tpu_torch.train.tasks import build_task

    cfg, batch_size, clip = step_config(family, dtype)
    t0 = time.perf_counter()
    task = build_task(cfg)
    state = task.init_state(0, "cuda")
    batch = step_batches(rng, 1, batch_size, clip)[0]
    if k == 1:
        def call():
            nonlocal state
            state, _ = task.train_step(state, batch, 1)
        warm = 3
    else:
        chunk = {n: v.expand(k, *v.shape) for n, v in batch.items()}
        graph = StepGraph(task, state, 1, chunk)

        def call():
            graph.replay(state, chunk, None)
        warm = 1
    capture_s = time.perf_counter() - t0
    for _ in range(warm):
        call()
    ms = []
    for _ in range(SPC_CALLS):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop) / k)
    med = statistics.median(ms)
    breakdown = device_breakdown(call, warm=False)
    return {"family": family, "dtype": dtype, "K": k, "B": batch_size,
            "T": clip[0], "calls": len(ms), "steps": len(ms) * k,
            "median_ms": med, "min_ms": min(ms), "max_ms": max(ms),
            "clips_per_s": batch_size / med * 1e3,
            "device_ms_per_step": breakdown["device_ms"] / k,
            "breakdown": breakdown, "setup_s": capture_s,
            "seconds": time.perf_counter() - t0}


def state_differ(a, b) -> dict:
    """The entries of two train states (state dict, Adam's moments, count,
    lr) that are not bit-identical, with their largest difference."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    out = {k: float((sa[k].double() - sb[k].double()).abs().max())
           for k in sa if not torch.equal(sa[k], sb[k])}
    for k in ("mu", "nu", "count", "lr"):
        x, y = getattr(a.opt_state, k), getattr(b.opt_state, k)
        if not torch.equal(x, y):
            out[f"opt.{k}"] = float((x.double() - y.double()).abs().max())
    return out


def parallel_d_run(mesh, workdir: Path, name: str, batches: list) -> tuple:
    """Family D at full width through a Trainer on `mesh`: PAR_EAGER eager
    steps, then one captured chunk of PAR_K steps (the collectives inside
    the graph where the mesh has a process group); the trainer and the
    summed metric vector."""
    from cvad_tpu_torch.train.engine import Trainer

    cfg = train_config(PAR_BATCH)
    tr = Trainer(cfg, mesh=mesh, out_dir=str(workdir / name))
    tr.init_state()
    total = None
    for b in batches[:PAR_EAGER]:
        _, m = tr.task.train_step(tr.state, tr.put_batch(b), tr._seed)
        vec = torch.stack([m[k].float() for k in sorted(m)])
        total = vec if total is None else total + vec
    _, total, _ = tr._multi(tr.state, tr.put_chunk(batches[PAR_EAGER:]),
                            total)
    torch.cuda.synchronize()
    return tr, total


def parallel_b_run(mesh, batch: dict) -> tuple:
    """Family B (memory_ae's width) on `mesh`: one step from seed 0 and
    the eval step after it; the state and the eval outputs."""
    from cvad_tpu_torch.train.tasks import build_task

    task = build_task(b_train_config(PAR_B_BATCH), mesh)
    state = task.init_state(0, "cuda")
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    state, _ = task.train_step(state, dev, 1)
    out = task.eval_step(state, dev)
    torch.cuda.synchronize()
    return state, {k: v.cpu() for k, v in out.items()}


def step_ms(tr, batch: dict, calls: int = PAR_TIME_CALLS) -> dict:
    """Eager train steps of `tr` on one device batch: CUDA-event time of
    each, median and spread (3 warm-up steps first)."""
    for _ in range(3):
        tr.task.train_step(tr.state, batch, tr._seed)
    ms = []
    for _ in range(calls):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        tr.task.train_step(tr.state, batch, tr._seed)
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    return {"calls": calls, "median_ms": statistics.median(ms),
            "min_ms": min(ms), "max_ms": max(ms)}


def phase_parallel(workdir: Path, card: str) -> dict:
    """Main path parallel: the multi-device layer on an NCCL process group
    of one rank (the machine has one card; NCCL refuses two ranks on one
    card), started in this process from a file:// rendezvous in
    `workdir` and destroyed after.  The mesh's data axis goes through
    every collective (`parallel/collectives.py`), each an exact copy over
    one rank, so each run must be bit-identical to the same run on the
    trivial mesh with no process group: family D at full width (B=256,
    uint8 64x64 clips) through the mesh Trainer, PAR_EAGER eager steps
    and one captured PAR_K-step graph with NCCL's all-reduce inside it
    (parameters, both Adam moments, the metric sums); family B at
    memory_ae's width, one step and the eval step (bank, parameters,
    predictions; K3); the sharded scorers of D (the fixture) and C against
    the plain scorers; `temporal_sharded_forward` at time axis 1 and T=64
    (conv1 on F.conv3d) within PAR_T64_TOL of the model's forward (K1).
    The counts are set to 0 before the mesh's runs and read after them
    (the no-group runs go first and are not counted).  Then the eager
    step time of the mesh trainer beside the plain one."""
    import torch.distributed as dist

    from cvad_tpu_torch.evaluation.scoring import (make_score_fn,
                                                   make_sharded_score_fn)
    from cvad_tpu_torch.models import CausalAnomalyDetector
    from cvad_tpu_torch.models.registry import build_model
    from cvad_tpu_torch.parallel.temporal import temporal_sharded_forward
    from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
    from cvad_tpu_torch.runtime.mesh import create_mesh, single_mesh
    from cvad_tpu_torch.runtime.multihost import start_group
    from cvad_tpu_torch.train.tasks import card_numerics

    t0 = time.perf_counter()
    rng = np.random.default_rng(PAR_SEED)
    batches = [{"clips": rng.integers(0, 256, (PAR_BATCH,) + CLIP,
                                      dtype=np.uint8),
                "labels": np.zeros(PAR_BATCH, np.float32)}
               for _ in range(PAR_EAGER + PAR_K)]
    b_batch = {"clips": rng.integers(0, 256, (PAR_B_BATCH,) + CLIP_B,
                                     dtype=np.uint8),
               "labels": (np.arange(PAR_B_BATCH) % 4 == 3).astype(
                   np.float32), "valid": np.ones(PAR_B_BATCH, np.float32)}
    fixture = load_torch_state_dict(str(CKPT))
    score_clips = rng.uniform(0, 1, (PAR_SCORE_CLIPS,) + CLIP).astype(
        np.float32)
    c_state = build_model(c_config(8).model, seed=0).state_dict()
    c_clips = rng.uniform(0, 1, (PAR_SCORE_CLIPS,) + C_CLIP).astype(
        np.float32)
    long_clips = rng.uniform(0, 1, (PAR_T64_CLIPS,) + LONG_CLIP).astype(
        np.float32)

    # the trivial mesh: no process group
    plain = single_mesh()
    ref_d, ref_total = parallel_d_run(plain, workdir, "par_plain", batches)
    ref_b, ref_eval = parallel_b_run(plain, b_batch)
    ref_scores_d = make_score_fn("d", fixture)(score_clips)
    ref_scores_c = make_score_fn("c", c_state)(c_clips)

    start_group(0, 1, (workdir / "nccl_rendezvous").as_uri(),
                torch.device("cuda", 0))
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"the process group's backend is {backend}")
        mesh = create_mesh()
        reset_counts()
        tr, total = parallel_d_run(mesh, workdir, "par_mesh", batches)
        state_b, got_eval = parallel_b_run(mesh, b_batch)
        scores_d = make_sharded_score_fn(fixture, mesh, "d")(score_clips)
        scores_c = make_sharded_score_fn(c_state, mesh, "c")(c_clips)
        model = CausalAnomalyDetector().cuda().eval()
        model.load_state_dict(fixture)
        with torch.no_grad(), card_numerics():
            sharded = temporal_sharded_forward(model, long_clips, mesh)
            x = torch.from_numpy(long_clips).cuda().permute(0, 4, 1, 2, 3)
            want = model(x.contiguous())
        torch.cuda.synchronize()
        launched = counts()
        d_differ = state_differ(tr.state, ref_d.state)
        b_differ = state_differ(state_b, ref_b)
        times = {"mesh": step_ms(tr, tr.put_batch(batches[0]))}
    finally:
        dist.destroy_process_group()
    times["plain"] = step_ms(ref_d, ref_d.put_batch(batches[0]))
    eval_equal = all(torch.equal(got_eval[k], ref_eval[k])
                     for k in ref_eval)
    scorers_equal = (all(np.array_equal(a, b) for a, b in
                         zip(scores_d, ref_scores_d))
                     and np.array_equal(scores_c, ref_scores_c))
    t64_err = max(float((a - b).abs().max())
                  for a, b in zip(sharded, want))
    line = {"phase": "parallel", "card": card, "backend": backend,
            "world_size": 1, "d": {"B": PAR_BATCH, "eager": PAR_EAGER,
                                   "graph_K": PAR_K, "n_differ": len(
                                       d_differ), "differ": dict(list(
                                           d_differ.items())[:8]),
                                   "metrics_equal": bool(torch.equal(
                                       total, ref_total)),
                                   "metric_sum": total.tolist()},
            "b": {"B": PAR_B_BATCH, "n_differ": len(b_differ),
                  "differ": dict(list(b_differ.items())[:8]),
                  "eval_equal": eval_equal,
                  "bank_fill": int(state_b.model.memory_bank().fill)},
            "scorers_equal": scorers_equal,
            "t64": {"clips": PAR_T64_CLIPS, "T": LONG_CLIP[0],
                    "max_abs_err": t64_err, "tol": PAR_T64_TOL},
            "kernel_launches": {k: launched[k] for k in (
                "tfold_conv1", "pairwise_l1_forward", "pairwise_l1_backward",
                "memory_min_cosine")},
            "collective_calls": {k: v for k, v in launched.items()
                                 if k in COLLECTIVES},
            "step_ms": times, "seconds": time.perf_counter() - t0}
    emit(line)
    check(not d_differ and line["d"]["metrics_equal"],
          f"family D on the NCCL mesh differs from no group: {d_differ}")
    check(not b_differ and eval_equal,
          f"family B on the NCCL mesh differs from no group: {b_differ}")
    check(scorers_equal, "a sharded scorer differs from the plain one")
    check(t64_err <= PAR_T64_TOL,
          f"temporal_sharded_forward at T=64 off by {t64_err}")
    for k in ("tfold_conv1", "pairwise_l1_forward", "pairwise_l1_backward",
              "memory_min_cosine"):
        check(launched[k] > 0, f"phase parallel never launched {k}")
    # D's eager steps, the graph's warm-up step and replayed steps, B's
    check(launched["reduce_gradients"] == PAR_EAGER + 1 + PAR_K + 1
          and launched["gather"] > 0 and launched["all_reduce_sum"] > 0,
          f"the collectives were not called: {line['collective_calls']}")
    del tr, ref_d, state_b, ref_b, model
    torch.cuda.empty_cache()
    return launched


def cli_json(*argv) -> tuple:
    """``cvad_tpu_torch.cli.main(argv)`` in this process: (exit code, the
    JSON lines it printed)."""
    import contextlib

    from cvad_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]


def avenue_tree(root: Path) -> Path:
    """An Avenue-layout tree (``training/frames/<video>/``,
    ``testing/frames/<video>/``) of RGB 64x64 PPM frames from the port's
    writer: COMPAT_VIDEOS train and test videos of COMPAT_FRAMES frames."""
    from cvad_tpu_torch.data.synthetic import write_synthetic_video_tree

    for split, n, name in (("Train", COMPAT_VIDEOS[0], "training"),
                           ("Test", COMPAT_VIDEOS[1], "testing")):
        write_synthetic_video_tree(str(root / "_w"), splits=(split,),
                                   videos_per_split=n,
                                   frames_per_video=COMPAT_FRAMES,
                                   channels=3, fmt="ppm",
                                   seed=COMPAT_SEED)
        (root / name).mkdir(parents=True)
        (root / "_w" / split).rename(root / name / "frames")
    return root


def compat_parity(tree: Path) -> dict:
    """`ImprovedMiniCausalVAD` on the card and on the CPU from the
    fixture, dropout off, over the tree's first COMPAT_PARITY_BATCHES
    train batches with injected pseudo-targets (the two devices' draws
    differ): each epoch's loss and components, and the plateau lr, of
    COMPAT_EPOCHS epochs, then the eval on the test split."""
    from cvad_tpu_torch.compat import ImprovedMiniCausalVAD
    from cvad_tpu_torch.config import preset
    from cvad_tpu_torch.data.datasets import create_avenue_dataloaders

    train, test = create_avenue_dataloaders(str(tree), batch_size=4)
    rng = np.random.default_rng(COMPAT_SEED)
    batches = []
    for videos, labels in train:
        batches.append({"clips": videos, "labels": labels,
                        "pseudo_targets": (rng.uniform(size=len(labels))
                                           < COMPAT_PSEUDO_RATE).astype(
                                               np.float32)})
        if len(batches) == COMPAT_PARITY_BATCHES:
            break
    cfg = preset("avenue_improved")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
    out = {}
    for dev in ("cuda", "cpu"):
        model = ImprovedMiniCausalVAD(device=dev, cfg=cfg)
        model.load_model(str(CKPT))
        epochs = []
        for _ in range(COMPAT_EPOCHS):
            loss, comps = model.train_epoch_improved(batches)
            epochs.append({"loss": loss, **comps,
                           "lr": model.optimizer.param_groups[0]["lr"]})
        preds, graphs, _ = model.evaluate_improved(test)
        out[dev] = {"epochs": epochs, "predictions": preds,
                    "graphs": graphs}
    return out


def phase_compat(workdir: Path, card: str) -> dict:
    """Main path compat: the reference-API drivers of
    `cvad_tpu_torch.compat` on the card over an Avenue-layout tree
    (`avenue_tree`; family D at full width, 64x64, T=8, batch 4):
    `train_improved_minicausal_vad` for COMPAT_EPOCHS epochs, then
    `train_minicausal_vad_on_avenue` and `test_trained_model` on the
    first driver's best_improved_model.pth; the counts set to 0 just
    before and read just after (K1 and K2 forward and backward must
    launch).  Then `compat_parity`: the card's losses and components
    within COMPAT_LOSS_RTOL of the CPU's, the lr equal, predictions and
    graphs within 1e-4."""
    from cvad_tpu_torch import compat

    t0 = time.perf_counter()
    tree = avenue_tree(workdir / "avenue")
    tree_s = time.perf_counter() - t0
    out2, out1 = workdir / "compat_v2", workdir / "compat_v1"
    reset_counts()
    t1 = time.perf_counter()
    _, hist2 = compat.train_improved_minicausal_vad(
        str(tree), num_epochs=COMPAT_EPOCHS, save_interval=1,
        output_dir=str(out2))
    _, hist1 = compat.train_minicausal_vad_on_avenue(
        str(tree), num_epochs=COMPAT_EPOCHS, save_interval=1,
        output_dir=str(out1))
    preds, graphs = compat.test_trained_model(
        str(out2 / "best_improved_model.pth"), str(tree))
    torch.cuda.synchronize()
    launched = counts()
    drivers_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    par = compat_parity(tree)
    parity_s = time.perf_counter() - t2
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                for a, b in zip(par["cuda"]["epochs"], par["cpu"]["epochs"])
                for k in b if k != "lr")
    lr_equal = all(a["lr"] == b["lr"] for a, b in
                   zip(par["cuda"]["epochs"], par["cpu"]["epochs"]))
    pred_err = float(np.abs(par["cuda"]["predictions"]
                            - par["cpu"]["predictions"]).max())
    graph_err = float(np.abs(par["cuda"]["graphs"]
                             - par["cpu"]["graphs"]).max())
    line = {"phase": "compat", "card": card,
            "tree": {"train_videos": COMPAT_VIDEOS[0],
                     "test_videos": COMPAT_VIDEOS[1],
                     "frames": COMPAT_FRAMES, "seconds": tree_s},
            "v2": {"train_losses": hist2["train_losses"],
                   "learning_rates": hist2["learning_rates"],
                   "evaluations": len(hist2["evaluation_metrics"]),
                   "files": sorted(p.name for p in out2.iterdir())},
            "v1": {"train_losses": hist1["train_losses"],
                   "evaluation_scores": hist1["evaluation_scores"],
                   "files": sorted(p.name for p in out1.iterdir())},
            "test_trained_model": {"clips": int(preds.shape[0]),
                                   "graphs": list(graphs.shape[1:])},
            "drivers_s": drivers_s,
            "parity": {"batches": COMPAT_PARITY_BATCHES,
                       "epochs": par["cuda"]["epochs"],
                       "cpu_epochs": par["cpu"]["epochs"],
                       "worst_rel_err": worst, "rtol": COMPAT_LOSS_RTOL,
                       "lr_equal": lr_equal, "predictions_err": pred_err,
                       "graphs_err": graph_err, "seconds": parity_s},
            "kernel_launches": {k: launched[k] for k in (
                "tfold_conv1", "pairwise_l1_forward",
                "pairwise_l1_backward", "memory_min_cosine")}}
    emit(line)
    check(all(np.isfinite(hist2["train_losses"] + hist1["train_losses"])),
          "a compat driver's loss is not finite")
    check((out2 / "best_improved_model.pth").is_file()
          and (out2 / "improved_training_history.json").is_file()
          and (out1 / "training_history.json").is_file(),
          "a compat driver did not write its files")
    check(np.isfinite(preds).all() and graphs.shape[1:] == (16, 16),
          "test_trained_model's outputs")
    check(worst <= COMPAT_LOSS_RTOL and lr_equal,
          f"compat on the card off the CPU's losses by {worst} (rel)")
    check(pred_err <= 1e-4 and graph_err <= 1e-4,
          f"compat's eval card vs CPU: {pred_err}, {graph_err}")
    for k in ("tfold_conv1", "pairwise_l1_forward", "pairwise_l1_backward"):
        check(launched[k] > 0, f"the compat path never launched {k}")
    return launched


def phase_convert(workdir: Path, card: str) -> dict:
    """Main path convert: `cli convert` of the family-D fixture into a run
    directory, `eval --out` on the card (against the same on the CPU:
    every metric within 1e-4), then `train --resume --epochs 1` on the
    card from it (a fresh optimizer at step 0, the loss finite), on
    CONVERT_CLIPS synthetic clips at batch CONVERT_BATCH; the counts set
    to 0 just before and read just after the card's commands (K1, K2)."""
    run = workdir / "convert_d"
    data = ["--n-synthetic", str(CONVERT_CLIPS), "--set",
            f"data.batch_size={CONVERT_BATCH}"]
    t0 = time.perf_counter()
    reset_counts()
    rc_c, conv = cli_json("convert", str(CKPT), "--family", "d", "--out",
                          str(run))
    rc_e, ev = cli_json("eval", "--out", str(run), *data)
    # the CPU's eval launches nothing: the counts run on through it
    rc_cpu, ev_cpu = cli_json("eval", "--out", str(run), *data,
                              "--device", "cpu")
    rc_t, tr = cli_json("train", "--out", str(run), "--resume", "--epochs",
                        "1", *data)
    torch.cuda.synchronize()
    launched = counts()
    ev_err = max(abs(ev[-1][k] - ev_cpu[-1][k]) for k in ev_cpu[-1]
                 if isinstance(ev_cpu[-1][k], float))
    line = {"phase": "convert", "card": card, "convert": conv[-1],
            "eval": ev[-1], "eval_cpu_max_abs_err": ev_err,
            "train": tr[-1], "resumed_from": tr[0].get("resumed_from"),
            "exit_codes": [rc_c, rc_e, rc_cpu, rc_t],
            "seconds": time.perf_counter() - t0,
            "kernel_launches": {k: launched[k] for k in (
                "tfold_conv1", "pairwise_l1_forward",
                "pairwise_l1_backward")}}
    emit(line)
    check([rc_c, rc_e, rc_cpu, rc_t] == [0, 0, 0, 0],
          f"a command of phase convert failed: {line['exit_codes']}")
    check(conv[-1]["params"] == 188849 and ev[-1]["epoch"] == 0
          and tr[0] == {"resumed_from": 0}
          and np.isfinite(tr[-1]["final_loss"]),
          f"phase convert: {line}")
    check(ev_err <= 1e-4, f"eval of the converted run card vs CPU {ev_err}")
    for k in ("tfold_conv1", "pairwise_l1_forward", "pairwise_l1_backward"):
        check(launched[k] > 0, f"the convert path never launched {k}")
    return launched


def temporal_config(name: str):
    """Phase temporal's configurations: C at mini3d's width, B with the
    attention encoder at memory_ae's width and T=128 (K6), A at full width
    on 240x360."""
    rows, _ = TEMPORAL_CASES[name]
    return {"c": c_config, "b_attn": attn_config,
            "a": a_config}[name](rows)


def temporal_batch(name: str) -> dict:
    """A case's global batch, uint8 clips, from TEMPORAL_SEED: a quarter
    of the rows labelled anomalous (family B trains on the others)."""
    rows, clip = TEMPORAL_CASES[name]
    rng = np.random.default_rng(TEMPORAL_SEED + list(TEMPORAL_CASES).index(
        name))
    return {"clips": rng.integers(0, 256, (rows,) + clip, dtype=np.uint8),
            "labels": (np.arange(rows) % 4 == 1).astype(np.float32),
            "valid": np.ones(rows, np.float32)}


def temporal_step(name: str, mesh) -> dict:
    """One float32 train step of a case from seed 0 on this rank's rows
    and frames of its global batch, and the eval step after it (dropout
    and the VAE draw on: both take the one-rank step's draws, made on the
    card from the same seed at the global rows)."""
    from cvad_tpu_torch.runtime.mesh import shard_batch
    from cvad_tpu_torch.train.tasks import build_task

    task = build_task(temporal_config(name), mesh)
    state = task.init_state(0, "cuda")
    time_dim = 1 if mesh.time.size > 1 else None
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in shard_batch(mesh, temporal_batch(name),
                                     time_dim).items()}
    state, metrics = task.train_step(state, batch, 1)
    out = task.eval_step(state, batch)
    torch.cuda.synchronize()
    return {"state": state.state_dict(),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "eval": {k: v.cpu() for k, v in out.items()}}


def temporal_rank(rank: int, world: int, out: str) -> None:
    """A rank of phase temporal's gloo group (started by
    `parallel.dryrun.run_world`): every case on the (1 x 2) mesh, with
    cuda:0 as its device; the counts set to 0 just before the cases and
    read just after."""
    from cvad_tpu_torch.runtime.mesh import create_mesh

    mesh = create_mesh(data_axis=1, temporal_axis=2)
    reset_counts()
    res = {"steps": {name: temporal_step(name, mesh)
                     for name in TEMPORAL_CASES}}
    res["counts"] = counts()
    torch.save(res, Path(out) / f"{rank}.pt")


def temporal_readings(name: str, got: dict, want: dict) -> dict:
    """A sharded step against the one-rank step: the metrics' worst
    relative difference, the parameters' largest difference (in lr) and
    their share beyond TEMPORAL_PARAM_TOL, the running statistics', bank's
    and eval outputs' largest difference beyond TEMPORAL_OUT_TOL."""
    lr = temporal_config(name).optim.lr
    rtol, atol = TEMPORAL_PARAM_TOL
    ortol, oatol = TEMPORAL_OUT_TOL
    from cvad_tpu_torch.models.registry import build_model

    g, w = got["state"]["model_state_dict"], want["state"]["model_state_dict"]
    params = {n for n, _ in build_model(
        temporal_config(name).model).named_parameters()}
    far = total = 0
    worst_p = worst_o = 0.0
    for k, v in g.items():
        if not v.is_floating_point():
            continue
        d = (v.double() - w[k].double()).abs()
        if k in params:
            worst_p = max(worst_p, float(d.max()))
            far += int((d > atol + rtol * w[k].double().abs()).sum())
            total += v.numel()
        else:
            worst_o = max(worst_o, float(
                (d - ortol * w[k].double().abs()).max()))
    for k, v in got["eval"].items():
        d = (v.double() - want["eval"][k].double()).abs()
        worst_o = max(worst_o, float(
            (d - ortol * want["eval"][k].double().abs()).max()))
    metric = max(abs(got["metrics"][k] - want["metrics"][k])
                 / max(abs(want["metrics"][k]), 1e-12)
                 for k in want["metrics"])
    return {"metric_rel_err": metric, "param_max_lr": worst_p / lr,
            "param_far_share": far / max(total, 1),
            "out_excess": worst_o, "out_atol": oatol,
            "loss": got["metrics"]["loss"]}


def phase_temporal(workdir: Path, card: str) -> dict:
    """Main path temporal: every family's train and eval steps on the
    time axis.  A gloo group of 2 processes with both ranks on cuda:0
    takes the port's CUDA collectives (all-gather, all-reduce, sub-groups,
    the autograd gathers and halos; NCCL refuses two ranks on one card),
    so the (1 data x 2 time) mesh runs here: C at mini3d's width (8 x 64 x
    64, B=8), B with attention at memory_ae's width and T=128 (B=4; K6
    over the gathered T, K3 in eval) and A at 16 x 240 x 360 (B=4), each
    one step and the eval step, against the one-rank step of the same
    global batch in this process (`temporal_readings`, the tolerances of
    TEMPORAL_*); the two ranks' states bit-identical.  The launch counts
    are each rank's over its cases, summed."""
    from cvad_tpu_torch.parallel.dryrun import run_world
    from cvad_tpu_torch.runtime.mesh import single_mesh

    t0 = time.perf_counter()
    one = {name: temporal_step(name, single_mesh())
           for name in TEMPORAL_CASES}
    one_s = time.perf_counter() - t0
    out = workdir / "temporal"
    out.mkdir()
    t1 = time.perf_counter()
    run_world(temporal_rank, 2, str(out), timeout=600)
    world_s = time.perf_counter() - t1
    ranks = [torch.load(out / f"{r}.pt", weights_only=False)
             for r in range(2)]
    launched = {k: sum(r["counts"][k] for r in ranks)
                for k in ranks[0]["counts"]}
    readings = {name: temporal_readings(name, ranks[0]["steps"][name],
                                        one[name])
                for name in TEMPORAL_CASES}
    replicas = {name: all(
        torch.equal(v, ranks[1]["steps"][name]["state"][part][k])
        for part in ("model_state_dict", "optimizer")
        for k, v in ranks[0]["steps"][name]["state"][part].items())
        for name in TEMPORAL_CASES}
    line = {"phase": "temporal", "card": card, "backend": "gloo",
            "world_size": 2, "mesh": {"data": 1, "time": 2},
            "cases": {name: {"B": TEMPORAL_CASES[name][0],
                             "clip": list(TEMPORAL_CASES[name][1]),
                             **readings[name],
                             "replicas_equal": replicas[name]}
                      for name in TEMPORAL_CASES},
            "tolerances": {"metric_rtol": TEMPORAL_METRIC_RTOL,
                           "param": TEMPORAL_PARAM_TOL,
                           "param_far_share": TEMPORAL_FAR_SHARE,
                           "outputs": TEMPORAL_OUT_TOL},
            "kernel_launches": {k: launched[k] for k in (
                "flash_forward", "flash_dq", "flash_dkv",
                "memory_min_cosine", "tfold_conv1")},
            "collective_calls": {k: v for k, v in launched.items()
                                 if k in COLLECTIVES},
            "one_rank_s": one_s, "world_s": world_s,
            "seconds": time.perf_counter() - t0}
    emit(line)
    for name, r in readings.items():
        check(replicas[name], f"temporal {name}: the ranks' states differ")
        check(r["metric_rel_err"] <= TEMPORAL_METRIC_RTOL
              and r["param_max_lr"] <= 2.0
              and r["param_far_share"] <= TEMPORAL_FAR_SHARE
              and r["out_excess"] <= TEMPORAL_OUT_TOL[1],
              f"temporal {name} off the one-rank step: {r}")
    for k in ("flash_forward", "flash_dq", "flash_dkv", "memory_min_cosine"):
        check(launched[k] > 0, f"the temporal path never launched {k}")
    check(launched["halo_exchange"] > 0 and launched["gather"] > 0,
          f"the time axis' collectives: {line['collective_calls']}")
    torch.cuda.empty_cache()
    return launched


def device_breakdown(fn, warm: bool = True) -> dict:
    """Device time by kernel over one call of `fn` (after one warm call
    unless `warm` is False, for a caller that warmed it), from
    torch.profiler; busy share = summed device time over the call's wall
    time (the call ends in a synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
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
        # families C and A (main paths 8 and 9; the fits reset the counts)
        paths["family_c_train"] = phase_family_c(Path(tmp), dev["card"])
        emit({"phase": "main_path", "path": "family_c_train",
              "launches": paths["family_c_train"]})
        paths["family_a_train"], state_a = phase_family_a(Path(tmp),
                                                          dev["card"])
        emit({"phase": "main_path", "path": "family_a_train",
              "launches": paths["family_a_train"]})
    # main path 7: frame-folder video (each path resets the counts first)
    # and phase family_e on the same tree (path video-e)
    for name, launched in phase_video(state, dev, state_a).items():
        paths[name] = launched
        emit({"phase": "main_path", "path": name, "launches": launched})
    # the anomaly report on an RGB tree (resets the counts first)
    paths["report"] = phase_report(dev)
    emit({"phase": "main_path", "path": "report",
          "launches": paths["report"]})
    # every family's scorer exported, loaded and served (each artefact's
    # calls reset the counts first: paths export_<artefact>)
    for name, launched in phase_export(dev["card"]).items():
        paths[name] = launched
        emit({"phase": "main_path", "path": name, "launches": launched})
    # K train steps in one CUDA graph, every train path (main paths
    # graph_<family>: the replays' counts; steps_per_call_fit)
    with tempfile.TemporaryDirectory(prefix="cvad_chip_smoke_") as tmp:
        spc_paths, spc_times = phase_steps_per_call(Path(tmp), dev["card"])
    for name, launched in spc_paths.items():
        paths[name] = launched
        emit({"phase": "main_path", "path": name, "launches": launched})
    # the multi-device layer on an NCCL group of one rank (main path
    # parallel; resets the counts first)
    with tempfile.TemporaryDirectory(prefix="cvad_chip_smoke_") as tmp:
        paths["parallel"] = phase_parallel(Path(tmp), dev["card"])
    emit({"phase": "main_path", "path": "parallel",
          "launches": paths["parallel"]})
    # the reference-API drivers, cli convert and every family on the time
    # axis (main paths compat, convert, temporal; each resets the counts)
    with tempfile.TemporaryDirectory(prefix="cvad_chip_smoke_") as tmp:
        for name, phase in (("compat", phase_compat),
                            ("convert", phase_convert),
                            ("temporal", phase_temporal)):
            paths[name] = phase(Path(tmp), dev["card"])
            emit({"phase": "main_path", "path": name,
                  "launches": paths[name]})

    # the eager rows of phase steps_per_call, and the K1 route at T=64
    eager = {(t["family"], t["dtype"]): t for t in spc_times if t["K"] == 1}
    train_times = [eager[(f, dt)] for f in ("d", "b", "d64")
                   for dt in ("float32", "bfloat16")]
    train_times += [train_step_times(rng, "float32", "d64_k1"),
                    train_step_times(rng, "bfloat16", "d64_k1")]
    train_times += [eager[("b_attn", dt)] for dt in ("float32", "bfloat16")]
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
          "train_step": train_times, "steps_per_call": spc_times,
          "pairwise_l1": pair_t,
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
