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
           tfold_conv1 at B in {1, 3, 128, 256}, T=8, 64x64, C=3, O=16;
           float32 within atol 1e-4, bfloat16 within |err| <= 1e-2*|ref|
           + 1e-5 against the plain version in float32 on the same
           bf16-rounded inputs;
           tfold_conv1's autograd gradient (x and weight, f32 and bf16, B=4)
           against autograd through the plain version: f32 within 1e-5 of
           the largest |ref|, bf16 within 2e-2 of it;
           pairwise_l1 forward and backward at B in {1, 2, 33, 256}, N in
           {1, 7, 256}, masks all zero / single / random / all one: avg
           within rtol 1e-5 (atol 1e-7), n_pairs exact, gradient within
           atol 1e-6, and a second call bit-identical
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
  times    kernel, plain-version and library times (CUDA events), the
           bounds, per-bucket request latency of both families, bulk
           clips/s, the train step of both families at B=256 in f32 and
           bf16 (median of 20) and its device time by kernel
           (torch.profiler)
Kernel launch counts are set to 0 just before each main path (serve + bulk,
train, family_b_train, family_b_serve) and read just after it.  The last
lines are the kernels summary, the card's nvidia-smi name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def emit(obj: dict) -> None:
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
    grad = check_tfold_grad(rng)
    pair = check_pairwise(rng)
    mem = check_memory(rng)
    emit({"phase": "kernels", "kernels": [
        {"name": "tfold_conv1", "comparison_launches": tfold_conv1.launches,
         "max_abs_err_f32": err32, "max_abs_err_bf16": err16,
         "cases": cases, "grad": grad},
        {"name": "pairwise_l1", **pair},
        {"name": "memory_min_cosine", **mem}]})
    return {"f32": err32, "bf16": err16, "pair_fwd": pair["max_abs_err_avg"],
            "pair_bwd": pair["max_abs_err_grad"],
            "memory": mem["max_abs_err"]}


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
            "comparison_launches": memory_min_cosine_distance.launches}


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
    call bit-identical to the first."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        pairwise_l1_backward_reference, pairwise_l1_mean,
        pairwise_l1_reference)

    err_avg = err_grad = 0.0
    n_cases = 0
    for b in (1, 2, 33, 256):
        for n in (1, 7, 256):
            for mask in ("zero", "single", "random", "one"):
                flat, m = pair_inputs(rng, b, n, mask)
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
    return {"cases": n_cases, "max_abs_err_avg": err_avg,
            "max_abs_err_grad": err_grad,
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

    return {"tfold_conv1": tfold_conv1.launches,
            "pairwise_l1_forward": pairwise_l1_mean.launches,
            "pairwise_l1_backward": pairwise_l1_mean.backward_launches,
            "memory_min_cosine": memory_min_cosine_distance.launches}


def reset_counts() -> None:
    from cvad_tpu_torch.ops.pallas_conv import tfold_conv1
    from cvad_tpu_torch.ops.pallas_kernels import (memory_min_cosine_distance,
                                                   pairwise_l1_mean)

    tfold_conv1.launches = 0
    pairwise_l1_mean.launches = pairwise_l1_mean.backward_launches = 0
    memory_min_cosine_distance.launches = 0


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
    check(all(v == (0 if k == "memory_min_cosine" else PARITY_STEPS)
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


def memory_times(rng: np.random.Generator) -> list:
    """K3 at MEM_SHAPES with a full bank: the kernel, the plain version, and
    the library yardstick F.normalize + torch.mm + torch.where + amin
    (which the port never calls), with the bound from this call's bytes
    (each input read once, the output written once) and operations
    (2 B fill D at the float32 rate)."""
    import torch.nn.functional as F

    from cvad_tpu_torch.ops.pallas_kernels import (
        _launch_memory, memory_min_cosine_distance_reference)

    def library(q, mem, f):
        sims = torch.mm(F.normalize(q, dim=1, eps=1e-8),
                        F.normalize(mem, dim=1, eps=1e-8).T)
        col = torch.arange(mem.shape[0], device=q.device)
        dist = torch.where(col[None, :] < f, 1.0 - sims.clamp(-1.0, 1.0),
                           3.0)
        return dist.amin(dim=1).clamp(0.0, 2.0) / 2.0

    out = []
    for b, m, d in MEM_SHAPES:
        q, mem = memory_inputs(rng, b, m, d)
        f = torch.tensor(m, dtype=torch.int32, device="cuda")
        err = (library(q, mem, f) - _launch_memory(q, mem, f)).abs().max()
        t = {"B": b, "M": m, "D": d, "fill": m,
             "ms": cuda_ms(lambda: _launch_memory(q, mem, f), iters=200),
             "plain_ms": cuda_ms(lambda: memory_min_cosine_distance_reference(
                 q, mem, f), iters=50),
             "library_ms": cuda_ms(lambda: library(q, mem, f), iters=50),
             "library_max_abs_diff": err.item(),
             **bound(((b + m) * d + b + 1) * 4, 2 * b * m * d,
                     PEAK_FLOPS[torch.float32])}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out.append(t)
    return out


def kernel_times(rng: np.random.Generator, dtype: torch.dtype) -> dict:
    """tfold_conv1 at the bulk shape (B=256): kernel, plain version and the
    library conv, with the bound from this call's bytes and operations."""
    import torch.nn.functional as F

    from cvad_tpu_torch.ops.pallas_conv import (tfold_conv1,
                                                tfold_conv1_reference)

    x = torch.from_numpy(rng.uniform(0, 1, (BULK_BATCH, 3) + CLIP[:3])
                         .astype(np.float32)).cuda().to(dtype)
    w = torch.from_numpy(rng.normal(0, 0.2, (16, 3, 3, 3, 3))
                         .astype(np.float32)).cuda().to(dtype)
    y = tfold_conv1(x, w)
    with no_tf32():
        ms = cuda_ms(lambda: tfold_conv1(x, w), iters=50)
        plain_ms = cuda_ms(lambda: tfold_conv1_reference(x, w), iters=10)
        library_ms = cuda_ms(lambda: F.conv3d(x, w, stride=(1, 2, 2),
                                              padding=1), iters=50)
    size = x.element_size()
    nbytes = (x.numel() + w.numel() + y.numel()) * size
    flops = 2 * 3 * 27 * y.numel()       # 81 MACs per output element
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bound = max(bytes_ms, ops_ms)
    return {"dtype": str(dtype).replace("torch.", ""), "B": BULK_BATCH,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound / ms, "bytes": nbytes, "flops": flops}


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time for `nbytes` moved and `ops` done at `peak`
    operations/s, and which of the two bounds it."""
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def pairwise_times(rng: np.random.Generator) -> dict:
    """K2 forward and backward at B = N = 256 with a mask at the main
    path's rate: kernels, plain versions, and torch.cdist(p=1) (the library
    call for the pairwise L1 matrix, which the port never calls) with its
    backward.  Simple operations (sub, abs or sign, add) count one each at
    the float32 rate."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        _launch_backward, _launch_forward, pairwise_l1_backward_reference,
        pairwise_l1_reference)

    b = n = 256
    flat, m = pair_inputs(rng, b, n, "random")
    ct = torch.ones((), device="cuda")
    avg, n_pairs = _launch_forward(flat, m)
    s = float(m.sum())
    pairs = float(n_pairs)
    fwd = {"ms": cuda_ms(lambda: _launch_forward(flat, m), iters=200),
           "plain_ms": cuda_ms(lambda: pairwise_l1_reference(flat, m),
                               iters=20),
           "library_ms": cuda_ms(lambda: torch.cdist(flat, flat, p=1),
                                 iters=200),
           **bound((b * n + b + 2) * 4, 3 * pairs * n,
                   PEAK_FLOPS[torch.float32])}
    fr = flat.clone().requires_grad_(True)
    w = torch.triu(m[:, None] * m[None, :], 1)
    lib_loss = (torch.cdist(fr, fr, p=1) * w).sum()
    bwd = {"ms": cuda_ms(lambda: _launch_backward(flat, m, n_pairs, ct),
                         iters=200),
           "plain_ms": cuda_ms(lambda: pairwise_l1_backward_reference(
               flat, m, n_pairs, ct), iters=20),
           "library_ms": cuda_ms(lambda: torch.autograd.grad(
               lib_loss, fr, retain_graph=True), iters=50),
           **bound((2 * b * n + b + 2) * 4, 3 * s * s * n,
                   PEAK_FLOPS[torch.float32])}
    for t in (fwd, bwd):
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
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
    steps.  Family B's labels are normal at the train split's rate."""
    from cvad_tpu_torch.train.tasks import build_task

    if family == "b":
        cfg, clip = b_train_config(TRAIN_BATCH, dtype=dtype), CLIP_B
    else:
        cfg, clip = train_config(TRAIN_BATCH, dtype=dtype), CLIP
    task = build_task(cfg)
    state = task.init_state(0, "cuda")
    batch = {"clips": torch.from_numpy(rng.integers(
        0, 256, (TRAIN_BATCH,) + clip, dtype=np.uint8)).cuda(),
        "labels": torch.from_numpy((rng.uniform(size=TRAIN_BATCH)
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
    return {"family": family, "dtype": dtype, "B": TRAIN_BATCH,
            "steps": len(ms),
            "median_ms": med, "min_ms": min(ms), "max_ms": max(ms),
            "clips_per_s": TRAIN_BATCH / med * 1e3,
            "breakdown": device_breakdown(step)}


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
                    for k, t, c in rows[:12]]}


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
    with tempfile.TemporaryDirectory(prefix="cvad_chip_smoke_") as tmp:
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

    train_times = [train_step_times(rng, "float32"),
                   train_step_times(rng, "bfloat16"),
                   train_step_times(rng, "float32", "b"),
                   train_step_times(rng, "bfloat16", "b")]
    pair_t = pairwise_times(rng)
    k1_bwd = tfold_backward_times(rng)
    mem_t = memory_times(rng)
    emit({"phase": "times", "card": dev["card"], "kernel": [times32, times16],
          "request_latency": latency, "request_latency_b": latency_b,
          "forward_breakdown": breakdown,
          "bulk": {"clips": BULK_CLIPS, "batch": BULK_BATCH,
                   "dtype": "bfloat16", "input": "uint8",
                   "seconds": bulk_s,
                   "clips_per_s": BULK_CLIPS / statistics.median(bulk_s)},
          "train_step": train_times, "pairwise_l1": pair_t,
          "tfold_conv1_backward_plain": k1_bwd, "memory_min_cosine": mem_t,
          "total_s": time.perf_counter() - t_start})

    def row(t: dict, err: float) -> dict:
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")} | {"max_abs_err": err}

    def launches(name: str) -> dict:
        by_path = {p: c[name] for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    emit({"kernels": [
        {"name": "tfold_conv1", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/tfold_conv1.cu",
         "replaces": "cvad_tpu/ops/pallas_conv.py:178",
         **launches("tfold_conv1"),
         "dtype": "float32", "B": BULK_BATCH,
         **row(times32, errs["f32"]),
         "bfloat16": row(times16, errs["bf16"]),
         "backward_plain_ms": k1_bwd, "card": dev["card"]},
        {"name": "pairwise_l1_forward", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/pairwise_l1.cu",
         "replaces": "cvad_tpu/ops/pallas_kernels.py:214",
         **launches("pairwise_l1_forward"),
         "dtype": "float32", "B": pair_t["B"], "N": pair_t["N"],
         **row(pair_t["forward"], errs["pair_fwd"]), "card": dev["card"]},
        {"name": "pairwise_l1_backward", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/pairwise_l1.cu",
         "replaces": "cvad_tpu/ops/pallas_kernels.py:243",
         **launches("pairwise_l1_backward"),
         "dtype": "float32", "B": pair_t["B"], "N": pair_t["N"],
         **row(pair_t["backward"], errs["pair_bwd"]), "card": dev["card"]},
        {"name": "memory_min_cosine", "route": "cuda",
         "source": "cvad_tpu_torch/csrc/memory_cosine.cu",
         "replaces": "cvad_tpu/ops/pallas_kernels.py:102",
         **launches("memory_min_cosine"),
         "dtype": "float32", "B": mem_t[0]["B"], "M": mem_t[0]["M"],
         "D": mem_t[0]["D"], **row(mem_t[0], errs["memory"]),
         "large": {k: mem_t[1][k] for k in ("B", "M", "D")}
         | row(mem_t[1], errs["memory"]), "card": dev["card"]}]})
    print(dev["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
