#!/usr/bin/env python3
"""Probe: chip_smoke.py's `long_train_parity` gradient check over many data
seeds, with each gradient held against float64 and every ReLU's decision
pinned to float64's.

    python scripts/probe_long_parity.py [SEED ...]

For each seed (default 0 to 15) it draws the phase's uint8 clips and
pseudo-labels from ``numpy.random.default_rng(seed)``, as the phase draws
them from its own generator (`chip_smoke.LONG_PARITY_SEED`), and runs
`chip_smoke.long_grad_parity`: family D at T=64, B=8 on the K5 route
(model seed 0, dropout 0), 3 float32 steps on the CPU; before each step,
at the CPU run's parameters on that step's batch, the CPU's float64
gradient (the reference, each ReLU's mask recorded), and with those masks
pinned the CPU's float32 gradient at its default thread count, the card's
float32 gradient, and a witness: the card's float32 gradient with conv1
on K1 (conv_group_impl 'stack', no K5).  For every leaf at every step it
reports

    e_card = max|g_card - g64| / max|g64|,  e_cpu and e_k1 likewise,

and, by ReLU (conv1-3 and the graph encoder's first layer), the decisions
the unpinned float32 forwards of the card and of the CPU flip against
float64's, how many of those lie farther from 0 than
`chip_smoke.FLIP_NEAR` of the layer's largest |float64| pre-activation,
and the largest |float64| over that entry among the flipped ones (`rel`;
`max_flip_rel` is the largest of a seed's, for the card and the CPU).
A seed passes where, at every step, e_card <= GRAD_ABS + GRAD_KAPPA *
e_cpu (1e-5 + 4 e_cpu) on every leaf and no flip lies far from 0
(`chip_smoke.parity_holds`).  Prints one JSON line a seed (each step's
worst leaf, the share of its bound, e_card / e_cpu, the flips and every
leaf's three numbers), then the card's name and power limit.  A planted
wrong forward (K5's forward scaled by 1.001 in a throwaway copy) shows
where that reading lies for a kernel at fault.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cvad_tpu_torch.train.tasks import build_task

    if not torch.cuda.is_available():
        print("probe_long_parity: no CUDA card", file=sys.stderr)
        return 1
    seeds = [int(a) for a in sys.argv[1:]] or list(range(16))
    cfg = cs.long_config(cs.LONG_PARITY_BATCH, conv1_mode="tfold")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
    task = build_task(cfg)
    k1_cfg = cfg.replace(model=cfg.model.replace(conv_group_impl="stack"))
    k1_model = build_task(k1_cfg).init_state(0, "cuda").model
    for seed in seeds:
        clips, targets = cs.long_parity_data(np.random.default_rng(seed))
        steps, flips = cs.long_grad_parity(task, cfg, clips, targets,
                                           witness=(k1_cfg, k1_model))[:2]
        out = []
        for step, flip in zip(steps, flips):
            leaves = {n: {"e_card": e["e_card"], "e_cpu": e["e_cpu"],
                          "e_k1": e["e_witness"]} for n, e in step.items()}
            worst = cs.worst_leaf(step)
            worst["e_k1"] = worst.pop("e_witness")
            out.append({"passes": cs.parity_holds(step, flip),
                        "worst": worst, "relu_flips": flip,
                        "leaves": leaves})
        print(json.dumps({
            "seed": seed, "threads": torch.get_num_threads(),
            "bound": {"abs": cs.GRAD_ABS, "kappa": cs.GRAD_KAPPA,
                      "relu_masks": "float64's", "flip_near": cs.FLIP_NEAR},
            "passes": all(s["passes"] for s in out),
            "max_share_of_bound": max(s["worst"]["share_of_bound"]
                                      for s in out),
            "max_flip_rel": {side: max(max(f[side]["rel"]) for f in flips)
                             for side in ("card", "cpu")},
            "steps": out}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
