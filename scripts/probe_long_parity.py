#!/usr/bin/env python3
"""Probe: chip_smoke.py's `long_train_parity` gradient check over many data
seeds, with each gradient held against float64.

    python scripts/probe_long_parity.py [SEED ...]

For each seed (default 0 to 15) it draws the phase's uint8 clips and
pseudo-labels from ``numpy.random.default_rng(seed)``, as the phase draws
them from its own generator (`chip_smoke.LONG_PARITY_SEED`), and runs
`chip_smoke.long_grad_parity`: family D at T=64, B=8 on the K5 route
(model seed 0, dropout 0), 3 float32 steps on the CPU; before each step,
at the CPU run's parameters on that step's batch, the CPU's float64
gradient (the reference), the CPU's float32 gradient at its default
thread count, the card's float32 gradient, and a witness: the card's
float32 gradient with conv1 on K1 (conv_group_impl 'stack', no K5).  For
every leaf at every step it reports

    e_card = max|g_card - g64| / max|g64|,  e_cpu and e_k1 likewise,

and whether the phase's rule holds: e_card <= GRAD_ABS + GRAD_KAPPA *
e_cpu (1e-5 + 4 e_cpu).  Prints one JSON line a seed (each step's worst
leaf, the share of its bound, e_card / e_cpu, and every leaf's three
numbers), then the card's name and power limit.

    python scripts/probe_long_parity.py --layers SEED ...

locates where a seed's gradients part, layer by layer, at each step's
parameters: the pre-activations of the four ReLUs of family D's
`models/family_d.py` (conv1-3 and the graph encoder's first layer) on the
card (K5 route), on the CPU in float32 and on the card on the K1 route,
each against the CPU's float64 ones (largest difference over the largest
float64 entry, and how many entries lie on the other side of 0 than in
float64: where the ReLU passes a gradient in one and not in the other);
then e_card, e_cpu and e_k1 as above, and again with those ReLUs' masks
pinned to float64's (relu(x) = x * mask64), which takes the ReLU
decisions out of the comparison and leaves the arithmetic.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Relus:
    """Stands in for `torch.nn.functional` inside `models/family_d.py`: its
    `relu` records each call's input (`record`), or applies the next of
    `masks` as relu(x) = x * mask (pinned); everything else is torch's."""

    def __init__(self, masks=None):
        self.masks, self.inputs = masks, []

    def __getattr__(self, name):
        import torch.nn.functional as F

        return getattr(F, name)

    def relu(self, x):
        if self.masks is None:
            self.inputs.append(x.detach().cpu().double())
            import torch.nn.functional as F

            return F.relu(x)
        mask = self.masks[len(self.inputs)]
        self.inputs.append(None)
        return x * mask.to(x.device, x.dtype)


def through(relus, fn):
    """fn() with `models/family_d.py`'s ReLUs replaced by `relus`."""
    from cvad_tpu_torch.models import family_d

    real = family_d.F
    family_d.F = relus
    try:
        return fn()
    finally:
        family_d.F = real


def layers(task, cfg, k1_cfg, k1_model, clips, targets) -> list:
    """The `--layers` report of one seed, a dict a step (see the module
    docstring), along the CPU run's float32 steps."""
    import torch

    import chip_smoke as cs

    cpu = task.init_state(0, "cpu")
    card = task.init_state(0, "cuda").model
    out = []
    for i in range(clips.shape[0]):
        args = (clips[i], targets[i], cpu.step)
        card.load_state_dict(cpu.model.state_dict(), strict=True)
        k1_model.load_state_dict(cpu.model.state_dict(), strict=True)
        runs = {"card": (cfg, card, torch.float32),
                "cpu": (cfg, cpu.model, torch.float32),
                "k1": (k1_cfg, k1_model, torch.float32),
                "f64": (cfg, cpu.model, torch.float64)}
        grads, pre = {}, {}
        for name, (c, model, dt) in runs.items():
            rec = Relus()
            grads[name] = through(rec, lambda: cs.step_grads(
                c, model, *args, dtype=dt))
            pre[name] = rec.inputs
        masks = [x > 0 for x in pre["f64"]]
        pinned = {name: through(Relus(masks), lambda: cs.step_grads(
            c, model, *args, dtype=dt))
            for name, (c, model, dt) in runs.items() if name != "f64"}
        g64 = grads["f64"]

        def report(g: dict) -> dict:
            return {f"e_{n}": cs.rel_errs(g[n], g64) for n in g
                    if n != "f64"}

        out.append({
            "relu_inputs": [{
                "shape": list(ref.shape),
                **{f"{n}_rel_err": ((pre[n][j] - ref).abs().max()
                                    / ref.abs().max()).item()
                   for n in ("card", "cpu", "k1")},
                **{f"{n}_sign_flips": int(((pre[n][j] > 0) != masks[j])
                                          .sum()) for n in ("card", "cpu",
                                                            "k1")}}
                for j, ref in enumerate(pre["f64"])],
            "grads": report(grads), "grads_relu_pinned": report(pinned)})
        cpu, _ = task.train_step(cpu, {
            "clips": torch.from_numpy(clips[i]),
            "pseudo_targets": torch.from_numpy(targets[i])}, 1)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cvad_tpu_torch.train.tasks import build_task

    if not torch.cuda.is_available():
        print("probe_long_parity: no CUDA card", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    by_layer = "--layers" in args
    seeds = [int(a) for a in args if a != "--layers"] or list(range(16))
    cfg = cs.long_config(cs.LONG_PARITY_BATCH, conv1_mode="tfold")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
    task = build_task(cfg)
    k1_cfg = cfg.replace(model=cfg.model.replace(conv_group_impl="stack"))
    k1_model = build_task(k1_cfg).init_state(0, "cuda").model
    for seed in seeds:
        clips, targets = cs.long_parity_data(np.random.default_rng(seed))
        if by_layer:
            print(json.dumps({"seed": seed, "steps": layers(
                task, cfg, k1_cfg, k1_model, clips, targets)}), flush=True)
            continue
        steps = cs.long_grad_parity(task, cfg, clips, targets,
                                    witness=(k1_cfg, k1_model))[0]
        out = []
        for step in steps:
            leaves = {n: {"e_card": e["e_card"], "e_cpu": e["e_cpu"],
                          "e_k1": e["e_witness"]} for n, e in step.items()}
            worst = cs.worst_leaf(step)
            worst["e_k1"] = worst.pop("e_witness")
            out.append({"passes": worst["share_of_bound"] <= 1.0,
                        "worst": worst, "leaves": leaves})
        print(json.dumps({
            "seed": seed, "threads": torch.get_num_threads(),
            "bound": {"abs": cs.GRAD_ABS, "kappa": cs.GRAD_KAPPA},
            "passes": all(s["passes"] for s in out),
            "max_share_of_bound": max(s["worst"]["share_of_bound"]
                                      for s in out),
            "steps": out}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
