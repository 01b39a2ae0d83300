"""The training window: `Trainer.train_epoch` of the port, epoch after
epoch, on clips held in the trainer's device clip cache.

Set-up builds one `Trainer` from the configuration and the traffic, loads
the benchmark's seeded weights into it, and drives its first calls through
``train_epoch`` as the window does (each ends its epoch: the history, the
scheduler's step and its new learning rate into the optimizer state), on
set-up epochs of distinct rows drawn shuffled from the cache by the seed
(the loader of `portbench/data.py`): single steps (three with one step a
call; one with K steps a call, which a lone batch gets), then, with K
steps a call, one call of K steps, the captured graph's first replay, at
the learning rate the first epoch's end set.  It reads each call's mean
loss, the first moment and the parameters after the first step, and the
learning rate after the last call, then trains one whole epoch to warm
every shape and the epoch's end.  The window then runs whole epochs until
`seconds` have passed, a fresh history every ``num_epochs`` epochs (the
configuration's run); its rate is all the clips of all its steps over its
whole time, the closing synchronize included.

After the window the trainer is freed and the reference
(`reference/<family>.py`) follows the same steps and epochs from the same
weights on the same rows with the same step seeds, its learning rate from
torch's own scheduler of the configuration's schedule.  Compared, each
against its limit (`limits/<cell>.json`):

- ``loss_gap``: the largest relative gap of a single step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  step's gradient as the optimizer took it (the program's worked out from
  its first moment, mu / (1 - b1)), over the larger of the reference
  leaf's norm and the median leaf's;
- ``change_gap``: the same of the parameters' change over the first step,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone);
- ``chunk_loss_gap`` (K steps a call): the relative gap of the K-step
  call's mean loss;
- ``lr_gap``: the relative gap of the optimizer state's learning rate
  after the last call.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench import data, harness
from portbench import trace as tr


def experiment_config(config: dict, traffic: dict, seed: int):
    """The port's `ExperimentConfig` of the configuration's preset with the
    file's sizes, and the traffic's batch, feed and dtype."""
    from cvad_tpu_torch import config as C

    cfg = C.preset(config["preset"])
    model = type(cfg.model)(**_tuples(config["model"]))
    d = config["data"]
    return cfg.replace(
        model=model, loss=C.LossConfig(**config["loss"]),
        optim=C.OptimConfig(**config["optim"]),
        data=cfg.data.replace(clip_len=d["clip_len"],
                              frame_size=tuple(d["frame_size"]),
                              channels=d["channels"],
                              batch_size=traffic["batch"],
                              transfer_dtype="uint8"),
        train=cfg.train.replace(seed=seed % 0x7FFFFFFF,
                                steps_per_call=traffic["steps_per_call"],
                                dtype=traffic["dtype"], device_cache="on"))


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _leaf_gap(prog: Dict[str, "object"], ref: Dict[str, "object"],
              keep: List[str], base: Dict[str, float]) -> Tuple[float, str]:
    """The worst leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's
    ‖ref‖ in `base`), and that leaf's name."""
    med = float(np.median(list(base.values())))
    worst = (0.0, "")
    for n in keep:
        a, b = float(prog[n].norm()), float(ref[n].norm())
        worst = max(worst, (abs(a - b) / max(b, med, 1e-30), n))
    return worst


def calls(k: int) -> List[int]:
    """The steps of each set-up call: three single steps, or one single
    step and one call of K."""
    return [1, 1, 1] if k == 1 else [1, k]


def checked_rows(n: int, b: int, k: int, seed: int) -> np.ndarray:
    """The rows of the set-up steps, one batch a line: distinct, drawn
    shuffled from the `n` clips by the seed."""
    steps = sum(calls(k))
    return np.random.default_rng(seed).permutation(n)[:steps * b].reshape(
        steps, b)


def checked_calls(trainer, loader, k: int, names: List[str]) -> dict:
    """The set-up calls through `trainer.train_epoch` on the epochs -1, -2,
    ... of `loader`: each call's mean loss, the first moment and the
    parameters after the first, and the learning rate after the last."""
    out = {"losses": []}
    for call in range(len(calls(k))):
        avg = trainer.train_epoch(loader, -(call + 1))
        out["losses"].append(float(avg["loss"]))
        if call == 0:
            params = trainer.state.params()
            flat = trainer.state.opt_state.mu.detach().cpu().clone()
            out["mu"] = {nm: v.view(p.shape) for nm, v, p in
                         zip(names, flat.split([p.numel() for p in params]),
                             params)}
            out["params_first"] = {nm: p.detach().cpu().clone()
                                   for nm, p in zip(names, params)}
    out["lr"] = float(trainer.state.opt_state.lr)
    return out


def compare(prog: dict, ref: dict, k: int, b1: float,
            worst: Optional[dict] = None) -> Dict[str, float]:
    """The numbers the cell compares (see the module docstring); `worst`,
    where given, takes the leaf that sets each gap."""
    names = ref["names"]
    sizes = calls(k)
    at, ref_calls = 0, []
    for n in sizes:
        ref_calls.append(float(np.mean(ref["losses"][at:at + n])))
        at += n
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref_calls)]
    single = [g for g, n in zip(gaps, sizes) if n == 1]
    prog_g = {n: prog["mu"][n] / (1 - b1) for n in names}
    ref_g = {n: ref["first_grad"][n].cpu() for n in names}
    gnorm = {n: float(ref_g[n].norm()) for n in names}
    med = float(np.median(list(gnorm.values())))
    moving = [n for n in names if gnorm[n] >= 1e-3 * med]
    p0 = prog["params0"]
    after = ref["params_steps"][0]
    dp = {n: prog["params_first"][n] - p0[n] for n in names}
    dr = {n: after[n].cpu() - p0[n] for n in names}
    grad = _leaf_gap(prog_g, ref_g, names, gnorm)
    change = _leaf_gap(dp, dr, moving, {n: float(dr[n].norm())
                                        for n in moving})
    if worst is not None:
        worst.update(grad_gap=grad[1], change_gap=change[1],
                     left_out=[n for n in names if n not in moving])
    out = {"loss_gap": max(single), "grad_gap": grad[0],
           "change_gap": change[0],
           "lr_gap": abs(prog["lr"] - ref["lr_last"])
           / max(abs(ref["lr_last"]), 1e-30)}
    if k > 1:
        out["chunk_loss_gap"] = gaps[-1]
    return out


def run(ctx) -> dict:
    torch = ctx.torch
    from cvad_tpu_torch.data.batcher import BatchLoader
    from cvad_tpu_torch.runtime.history import TrainingHistory
    from cvad_tpu_torch.train.engine import Trainer
    from cvad_tpu_torch.train.graphs import read_counters

    config, traffic, seed = ctx.config, ctx.traffic, ctx.seed
    dev = ctx.device
    cfg = experiment_config(config, traffic, seed)
    ref = harness.reference(config["reference"])
    b, k = traffic["batch"], traffic["steps_per_call"]
    n = traffic["clips"]
    d = config["data"]
    shape = (d["clip_len"], *d["frame_size"], d["channels"])
    clips, labels = data.seeded_clips(torch, n, shape,
                                      traffic["anomaly_share"], seed, dev)
    rows = checked_rows(n, b, k, seed)
    fixed, at = {}, 0
    for i, m in enumerate(calls(k)):  # set-up epochs -1, -2, ...
        fixed[-(i + 1)] = list(rows[at:at + m])
        at += m
    loader = data.seeded_loader(BatchLoader, data.ArrayClips(clips, labels),
                                b, seed, fixed)
    ctx.mark("clips made")
    weights = ref.make_weights(config, seed, dev)
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    trainer = Trainer(cfg, out_dir=tmp.name, device=dev)
    trainer.init_state()
    with torch.no_grad():
        trainer.state.model.load_state_dict(weights, strict=True)
    names = [nm for nm, p in trainer.state.model.named_parameters()
             if p.requires_grad]
    params0 = {nm: weights[nm].detach().cpu().clone() for nm in names}
    ctx.fault_hook("trainer", trainer)
    ctx.mark("trainer built")

    # the set-up calls the reference follows
    prog = {**checked_calls(trainer, loader, k, names), "params0": params0}
    ctx.mark("checked calls")
    if ctx.trace:
        ctx.profiler().prime()
    # one whole epoch warms the epoch's shapes and its end
    steps_per_epoch = math.ceil(n / b)
    trainer.train_epoch(loader, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start

    # the window
    runs_of = config["train"]["num_epochs"]
    epoch, steps, bad_steps = 1, 0, 0
    trace, prof = None, None
    slice_steps, slice_s, counters0 = 0, 0.0, None
    trace_at = tr.slice_start(ctx.seconds)
    ends = []  # (seconds into the window, steps) at each epoch's end
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if ctx.trace and prof is None and trace is None and now >= trace_at:
            prof = ctx.profiler()
            prof.start()
            t_slice, counters0 = time.perf_counter(), read_counters()
        if epoch % runs_of == 1 and epoch > 1:  # the next run's history
            trainer.history = TrainingHistory(trainer.history.path)
        with torch.profiler.record_function("portbench.train_epoch"):
            avg = trainer.train_epoch(loader, epoch)
        steps += steps_per_epoch
        if not math.isfinite(avg.get("loss", float("nan"))):
            bad_steps += steps_per_epoch
        if prof is not None:
            slice_steps += steps_per_epoch
            if time.perf_counter() - t_slice >= tr.SLICE_S:
                counters = read_counters()
                trace = prof.stop({
                    "steps": slice_steps, "clips": slice_steps * b,
                    **{f"launches.{nm}": counters[nm] - counters0[nm]
                       for nm in counters}})
                prof = None
                # the slice, and the reading of its trace
                slice_s = time.perf_counter() - t_slice
        epoch += 1
        ends.append((time.perf_counter() - t0, steps))
        if (ends[-1][0] >= ctx.seconds and prof is None
                and (trace is not None or not ctx.trace)):
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    clips_done = steps * b
    peak = ctx.memory_peak()

    # free the program, then the reference
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_out = ref.train_steps(
        config, weights, [torch.from_numpy(clips[r]) for r in rows],
        [torch.from_numpy(labels[r]) for r in rows], cfg.train.seed + 1, dev,
        calls(k), compute=traffic["dtype"])
    worst: dict = {}
    readings = compare(prog, ref_out, k, config["optim"]["b1"], worst)
    print(json.dumps({"worst_leaf": worst}), file=sys.stderr, flush=True)
    tmp.cleanup()
    return {"end_to_end": {"train_clips_per_s": clips_done / window,
                           "setup_s": setup_s},
            "attempted": steps, "failed": bad_steps, "readings": readings,
            "memory_peak_bytes": peak, "trace": trace,
            "info": {"window_s": window, "steps": steps, "epochs": epoch - 1,
                     "batch": b, "steps_per_call": k,
                     # the window's rate outside the profiled slice
                     "unprofiled_clips_per_s": (clips_done - slice_steps * b)
                     / (window - slice_s),
                     **fifths(ends, b)}}


def fifths(ends: List[Tuple[float, int]], b: int) -> Dict[str, float]:
    """The rate of the epochs that end in the window's first and last
    fifths: a rate that falls over the window shows as a last fifth far
    slower than the first."""
    if len(ends) < 10:
        return {}
    fifth = len(ends) // 5
    first, last = ends[fifth - 1], ends[-fifth - 1]
    return {"first_fifth_clips_per_s": first[1] * b / first[0],
            "last_fifth_clips_per_s": (ends[-1][1] - last[1]) * b
            / (ends[-1][0] - last[0])}
