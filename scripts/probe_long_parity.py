#!/usr/bin/env python3
"""Probe: chip_smoke.py's `long_train_parity` over several data seeds, and
where the card and the CPU part.

    python scripts/probe_long_parity.py [SEED ...]

For each seed (default 0 to 7) it draws the phase's uint8 clips and
pseudo-labels from ``numpy.random.default_rng(seed)`` and runs the phase's
3 float32 train steps of family D at T=64, B=8 on the K5 route (model seed
0, dropout 0) on the CUDA card and on the CPU.  Prints one JSON line a
seed, then the card's name and power limit: the largest parameter
difference and the phase's bound (5e-5); the three leaves that differ
most; and, at the worst entry, both values and Adam's state after the
last step on each side: the bias-corrected first moment m and the square
root of the second, s, whose ratio sets the update lr * m / (s + 1e-8),
beside the median s of its leaf.  Adam moves an entry by about lr *
sign(g) while g is steady, so where the gradient is near 0 (s small
against its leaf's) a rounding-level difference in g can move the
parameter by a good share of lr: the size of s tells whether that is
what happens.  Two witnesses beside each seed: the CPU at one thread
against the CPU at its default threads (float32 sums in another order,
no card), and the card with conv1 on K1 (conv_group_impl 'stack')
against the CPU on the same route (no K5).  Then the phase's bounded
check (`chip_smoke.long_grad_parity`): at each of the 3 steps the card's
gradient at the CPU run's parameters on that step's batch, each leaf's
largest difference over its largest |CPU| entry, against 1e-5; the line
gives each step's worst leaf and whether the seed passes, beside two
witnesses at step 1 (the same parameters) measured the same way: the CPU
at one thread against the CPU at its default threads, and the card with
conv1 on K1 against the CPU on that route.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BOUND = 5e-5  # the parameter bound the phase held before its gradient check
GRAD_BOUND = 1e-5  # chip_smoke.py::phase_long_train_parity's gradient bound


def run(task, clips, targets, dev):
    import torch

    st = task.init_state(0, dev)
    for i in range(clips.shape[0]):
        st, _ = task.train_step(st, {
            "clips": torch.from_numpy(clips[i]).to(dev),
            "pseudo_targets": torch.from_numpy(targets[i]).to(dev)}, 1)
    o = st.opt_state
    c = int(o.count)
    return ({k: v.detach().cpu() for k, v in st.model.named_parameters()},
            o.mu.cpu() / (1 - 0.9 ** c),
            (o.nu.cpu() / (1 - 0.999 ** c)).sqrt(), float(o.lr))


def largest(pa: dict, pb: dict) -> list:
    """(max |pa - pb|, leaf, flat index, flat offset, size) of each leaf,
    largest first."""
    leaves, off = [], 0
    for name, p in pb.items():
        d = (pa[name] - p).abs().flatten()
        i = int(d.argmax())
        leaves.append((d[i].item(), name, i, off, p.numel()))
        off += p.numel()
    return sorted(leaves, reverse=True)


def worst_rel(ga: dict, gb: dict) -> dict:
    """The leaf whose largest |ga - gb| is the largest share of its largest
    |gb| entry, and that share."""
    errs = {n: (ga[n] - g).abs().max().item() / max(g.abs().max().item(),
                                                     1e-30)
            for n, g in gb.items()}
    name = max(errs, key=errs.get)
    return {"leaf": name, "rel_err": errs[name]}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cvad_tpu_torch.train.tasks import build_task

    if not torch.cuda.is_available():
        print("probe_long_parity: no CUDA card", file=sys.stderr)
        return 1
    seeds = [int(a) for a in sys.argv[1:]] or list(range(8))
    cfg = cs.long_config(cs.LONG_PARITY_BATCH, conv1_mode="tfold")
    cfg = cfg.replace(model=cfg.model.replace(dropout=0.0))
    assert (cfg.optim.b1, cfg.optim.b2) == (0.9, 0.999)
    task = build_task(cfg)
    k1_task = build_task(cfg.replace(
        model=cfg.model.replace(conv_group_impl="stack")))
    threads = torch.get_num_threads()
    for seed in seeds:
        rng = np.random.default_rng(seed)
        clips = rng.integers(0, 256, (cs.PARITY_STEPS, cs.LONG_PARITY_BATCH)
                             + cs.LONG_CLIP, dtype=np.uint8)
        targets = (rng.uniform(size=(cs.PARITY_STEPS, cs.LONG_PARITY_BATCH))
                   < 0.25).astype(np.float32)
        pg, mg, sg, lr = run(task, clips, targets, "cuda")
        pc, mc, sc, _ = run(task, clips, targets, "cpu")
        leaves = largest(pg, pc)
        err, name, i, off, size = leaves[0]
        j = off + i
        torch.set_num_threads(1)
        p1 = run(task, clips, targets, "cpu")[0]
        torch.set_num_threads(threads)
        cpu_threads = largest(p1, pc)[0]
        k1 = largest(run(k1_task, clips, targets, "cuda")[0],
                     run(k1_task, clips, targets, "cpu")[0])[0]
        grads = cs.long_grad_parity(task, cfg, clips, targets)[0]
        worst = [max(g.items(), key=lambda kv: kv[1]) for g in grads]
        # witnesses at step 1, where the parameters are the same: the CPU at
        # one thread against the CPU at its default threads, and the K1
        # route's card gradient against the CPU's on the same route
        st0 = task.init_state(0, "cpu")
        g_cpu = cs.step_grads(cfg, st0.model, clips[0], targets[0], 0)
        torch.set_num_threads(1)
        g_cpu1 = cs.step_grads(cfg, st0.model, clips[0], targets[0], 0)
        torch.set_num_threads(threads)
        k1_cpu = k1_task.init_state(0, "cpu").model
        k1_card = k1_task.init_state(0, "cuda").model
        g_k1 = [cs.step_grads(cfg, m, clips[0], targets[0], 0)
                for m in (k1_card, k1_cpu)]
        print(json.dumps({
            "seed": seed, "params_max_abs_err": err, "bound": BOUND,
            "passes": err <= BOUND, "lr": lr,
            "worst_leaves": [{"leaf": n, "max_abs_err": e}
                             for e, n, *_ in leaves[:3]],
            "worst_entry": {
                "leaf": name, "index": i, "card": pg[name].flatten()[i].item(),
                "cpu": pc[name].flatten()[i].item(),
                "m_card": mg[j].item(), "m_cpu": mc[j].item(),
                "s_card": sg[j].item(), "s_cpu": sc[j].item(),
                "s_median_of_leaf": sc[off:off + size].median().item(),
                "entries_past_bound": int(sum(
                    ((pg[n] - pc[n]).abs() > BOUND).sum().item()
                    for n in pc))},
            "cpu_1_thread_vs_cpu_%d" % threads: {
                "max_abs_err": cpu_threads[0], "leaf": cpu_threads[1]},
            "k1_route_card_vs_cpu": {"max_abs_err": k1[0], "leaf": k1[1]},
            "grad_parity": {
                "bound": GRAD_BOUND,
                "passes": all(e <= GRAD_BOUND for _, e in worst),
                "worst_leaf_by_step": [{"leaf": n, "rel_err": e}
                                       for n, e in worst],
                "step1_cpu_1_thread_vs_cpu_%d" % threads:
                    worst_rel(g_cpu1, g_cpu),
                "step1_k1_route_card_vs_cpu": worst_rel(*g_k1)}}),
            flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
