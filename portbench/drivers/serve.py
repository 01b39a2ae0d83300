"""The serving window: an open loop of requests into the port's
`BatchingServer`, over `ClipScoringService` and a family's eager scorer,
as ``cli serve`` builds them (its buckets and coalescing window), without
HTTP.

Set-up loads the benchmark's seeded weights into the scorer, warms every
bucket twice in the clients' dtype, makes the pool of clips, and offers
``warmup_s`` of the same traffic, so that the window opens on a queue in
its steady state.  The traffic is a fixed amount of work: ``rate *
(warmup_s + seconds)`` requests of one clip each, whose arrival gaps are
one exponential draw of the traffic's own ``arrival_seed`` put in another
order by the run's seed and scaled to span the warm-up and the window, so
every seed offers the same load; each request's clip is drawn from the
pool by the seed.  The main thread hands each request to a pool of client
threads at its due time; each client calls ``BatchingServer.submit`` and
waits.  A request is timed from its due time to its scores being back in
its client thread; one that fails or never comes is beyond any latency.
The tail is over the window's requests; every request, the warm-up's
too, counts as attempted and must be answered.  After the last due time
the clients are given ``drain_s`` to finish.

Correctness: once the window has closed and the server has stopped, a
sample of ``check_sample`` answered requests drawn from the seed is held
against the reference (`reference/<family>.py`, float32, TF32 off), which
scores each of their clips once from the same weights; ``score_gap`` is
the widest gap between a served score and the reference's.  Every
request must be answered.
"""

from __future__ import annotations

import gc
import json
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import data, harness
from portbench import trace as tr


def schedule(traffic: dict, seconds: float, seed: int) -> np.ndarray:
    """The due times (seconds from the window's start) of the window's
    requests."""
    n = max(1, int(round(traffic["rate"] * seconds)))
    gaps = np.random.default_rng(traffic["arrival_seed"]).exponential(
        1.0, n + 1)
    gaps = np.random.default_rng(seed).permutation(gaps)
    return seconds * np.cumsum(gaps)[:n] / gaps.sum()


def percentile(values, q: float) -> float:
    """The nearest-rank `q` quantile (an unanswered request is inf)."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def run(ctx) -> dict:
    torch = ctx.torch
    from cvad_tpu_torch.config import FAMILY_CONFIGS
    from cvad_tpu_torch.evaluation.scoring import make_score_fn
    from cvad_tpu_torch.evaluation.serving import (BatchingServer,
                                                   ClipScoringService)

    config, traffic, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    ref = harness.reference(config["reference"])
    d = config["data"]
    shape = (d["clip_len"], *d["frame_size"], d["channels"])
    model_cfg = FAMILY_CONFIGS[config["family"]](**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in config["model"].items()})
    weights = ref.make_weights(config, seed, dev)
    fn = make_score_fn(config["family"], weights, cfg=model_cfg, device=dev)
    svc = ClipScoringService(fn, buckets=tuple(traffic["buckets"]),
                             clip_shape=shape)
    ctx.fault_hook("service", svc)
    server = BatchingServer(svc, max_wait_ms=traffic["max_wait_ms"])
    pool, _ = data.seeded_clips(torch, traffic["pool"], shape, 0.0, seed, dev)
    ctx.mark("scorer built")
    for _ in range(2):
        svc.warmup(dtypes=("uint8",))
    ctx.mark("buckets warmed")
    if ctx.trace:
        ctx.profiler().prime()
    warm = traffic["warmup_s"]
    due = schedule(traffic, warm + ctx.seconds, seed) - warm
    pick = np.random.default_rng(seed + 1).integers(0, len(pool), len(due))
    window_req = np.flatnonzero(due >= 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    lat = [math.inf] * len(due)
    served = [None] * len(due)
    late = np.zeros(len(due))
    done_at = np.full(len(due), math.nan)

    def request(i: int, t0: float) -> None:
        with torch.profiler.record_function("portbench.request"):
            try:
                res = server.submit(pool[pick[i]][None],
                                    timeout=traffic["drain_s"] + ctx.seconds)
            except (TimeoutError, RuntimeError):
                return
        t = time.perf_counter()
        if res.error is None and len(res.scores) == 1:
            lat[i] = (t - t0 - due[i]) * 1e3
            served[i] = float(res.scores[0])
            done_at[i] = t - t0

    prof, trace, stats_slice, stats0 = None, None, None, None
    trace_at = tr.slice_start(ctx.seconds)
    clients = ThreadPoolExecutor(max_workers=traffic["clients"])
    t0 = time.perf_counter() + warm  # the window's start
    for i, t_due in enumerate(due):
        wait = t0 + t_due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if stats0 is None and t_due >= 0:  # the window opens
            stats0 = server.stats()
            setup_s = time.perf_counter() - ctx.t_start
        late[i] = time.perf_counter() - t0 - t_due
        clients.submit(request, i, t0)
        if ctx.trace and t_due >= 0:
            now = time.perf_counter() - t0
            if prof is None and trace is None and now >= trace_at:
                prof = ctx.profiler()
                prof.start()  # the slice starts when the profiler is up
                stats_slice = server.stats()
            elif prof is not None and time.perf_counter() - prof.t0 >= \
                    tr.SLICE_S:
                trace = prof.stop(_delta(server.stats(), stats_slice))
                prof = None
    if prof is not None:
        trace = prof.stop(_delta(server.stats(), stats_slice))
    clients.shutdown(wait=True)
    window = time.perf_counter() - t0  # to the last answer
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stats = _delta(server.stats(), stats0)
    peak = ctx.memory_peak()
    server.close()
    answered = [i for i, s in enumerate(served) if s is not None]
    failed = len(due) - len(answered)
    wlat = [lat[i] for i in window_req]
    fifth = len(wlat) // 5 or 1
    print(json.dumps({"generator_lateness_ms": {
        "p50": float(np.median(late) * 1e3),
        "p99": float(np.quantile(late, 0.99) * 1e3),
        "max": float(late.max() * 1e3)},
        "requests": len(due), "window_requests": len(wlat),
        "answered": len(answered),
        "p95_first_fifth_ms": percentile(wlat[:fifth], 0.95),
        "p95_last_fifth_ms": percentile(wlat[-fifth:], 0.95),
        "drain_after_close_s": float(np.nanmax(done_at) - ctx.seconds)
        if answered else None}), flush=True)

    # free the program, then the reference on a sample of the answers
    del fn, svc, server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 2)
    sample = rng.choice(answered, min(traffic["check_sample"],
                                      len(answered)), replace=False) \
        if answered else np.zeros(0, int)
    clips, of = np.unique(pick[sample], return_inverse=True)
    got = ref.scores(config, weights, torch.from_numpy(pool[clips]),
                     dev).cpu()
    gap = max((abs(served[i] - float(got[j])) for i, j in zip(sample, of)),
              default=math.inf)
    return {"end_to_end": {"request_p95_ms": percentile(wlat, 0.95),
                           "setup_s": setup_s},
            "attempted": len(due), "failed": failed,
            "readings": {"score_gap": gap},
            "memory_peak_bytes": peak, "trace": trace,
            "info": {"window_s": window, "stats": stats,
                     "requests": len(wlat), "clips": len(wlat)}}


def _delta(now: dict, before: dict) -> dict:
    return {f"stats.{k}": now[k] - before.get(k, 0) for k in
            ("requests_total", "clips_total", "batches_total",
             "errors_total", "score_seconds_total")}
