#!/usr/bin/env python3
"""Probe: the card-vs-CPU train-step checks of chip_smoke.py's phases
`family_c` and `family_a` (`chip_smoke.step_parity`), with their readings
where a check would fail.

    python scripts/probe_family_parity.py [c] [a]

On each phase's own data (`chip_smoke.C_SEED`, `A_SEED`, drawn in the
phase's order): family C (mini3d, B=8, 8x64x64x1, from the seed-0 init)
and family A at full width (causal_pipeline, B=4, 16x240x360x1, from
`chip_smoke.a_step_head`, whose boxes cross the validity thresholds).  For
each of the PARITY_STEPS steps, taken on the card and on the CPU from the
CPU run's train state with every ReLU mask and max-pool argmax pinned to
the CPU's float64 forward, it reports `step_readings` (also at the
steady-entry thresholds 1e-4 and 1e-2 besides STEP_TINY_REL) and
`grad_readings`, and whether `step_holds` and the gradient rule pass.
Unpinned, for the first step from the same weights: each leaf's card
minus CPU float32 gradient over the CPU's largest entry (the four worst),
and by ReLU and max-pool call the decisions the card's forward takes
otherwise than the CPU's, with the largest |pre-activation| among them
over the layer's largest (`rel`).

Prints one JSON line a family, then the card's name and power limit.  Run
in a throwaway copy with a planted fault (the card's gradient of one conv
weight scaled by 1.001, or offset by 1e-3 of its largest entry), it shows
where the readings lie for a card at fault.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def unpinned(cs, cfg, batch: dict, state) -> dict:
    """The first step's float32 gradient and decisions, card against CPU,
    nothing pinned."""
    import torch

    from cvad_tpu_torch.train.tasks import build_task

    task, got, rec = build_task(cfg), {}, {}
    for dev in ("cpu", "cuda"):
        model = cs.no_dropout(task.init_state(0, dev).model)
        if state is not None:
            model.load_state_dict(state, strict=True)
        with cs.Relus() as relus, cs.Pools() as pools:
            got[dev] = cs.loss_grads(cfg, model, batch, torch.float32)
        rec[dev] = (relus, pools)
    e = cs.rel_errs(got["cuda"], got["cpu"])
    flips = []
    for j, (mg, mc) in enumerate(zip(rec["cuda"][0].masks,
                                     rec["cpu"][0].masks)):
        diff = mg != mc
        if bool(diff.any()):
            flips.append({"relu": j, "n": int(diff.sum()),
                          "rel": float(rec["cpu"][0].rel[j][diff].max())})
    pool_flips = [int((a != b).sum()) for a, b in zip(
        rec["cuda"][1].indices, rec["cpu"][1].indices)]
    return {"grad_worst_leaves": {n: e[n] for n in sorted(
                e, key=e.get, reverse=True)[:4]},
            "relu_flips": flips, "max_pool_flips": pool_flips}


def probe(cs, family: str) -> dict:
    import numpy as np

    from cvad_tpu_torch.models import CausalPipelineDetector

    if family == "c":
        rng = np.random.default_rng(cs.C_SEED)
        rng.uniform(0, 1, (64,) + cs.C_CLIP)  # the phase's scorer clips
        cfg, batches, state = cs.c_config(cs.C_BATCH), cs.c_step_batches(
            rng), None
    else:
        rng = np.random.default_rng(cs.A_SEED)
        cs.a_clips(rng, cs.A_BATCH)  # the phase's forward clips
        cfg, batches = cs.a_config(cs.A_BATCH), cs.a_step_batches(rng)
        state = cs.a_step_head(CausalPipelineDetector(seed=0).state_dict(),
                               batches)
    out = cs.step_parity(cfg, batches, state, probe=family == "a",
                         sweep=(1e-4, 1e-2), checked=False)
    lr = cfg.optim.lr
    return {"family": family, "lr": lr,
            "limits": {"param_atol": cs.STEP_PARAM_ATOL,
                       "tiny_rel": cs.STEP_TINY_REL,
                       "far_share": cs.STEP_FAR_SHARE,
                       "metrics_rtol": cs.STEP_RTOL,
                       "stats_rel": cs.STEP_STATS_REL,
                       "grad_f64_rel": cs.GRAD_F64_REL,
                       "grad_kappa": cs.GRAD_KAPPA},
            "steps_hold": [cs.step_holds(s, lr) for s in out["steps"]],
            "grads_hold": [s["grad"]["holds"] for s in out["steps"]],
            "steps": out["steps"],
            "unpinned_first_step": unpinned(cs, cfg, batches[0], state)}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("probe_family_parity: no CUDA card", file=sys.stderr)
        return 1
    for family in sys.argv[1:] or ["c", "a"]:
        print(json.dumps(probe(cs, family)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
