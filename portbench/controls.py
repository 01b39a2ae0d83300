"""The readings that set each cell's upper limits: the control (the
reference in the program's place, computed in the precision below the
cell's: TF32 for float32 with TF32 off, float8 for bfloat16) and the
faults a cell can have, each compared with the reference as a run
compares the program.

    python3 portbench/controls.py --workload NAME --seeds S [S ...]

Prints one JSON line a seed: each reading, and beside it whether it
passes the cell's limits as a run's would (``correct``).  A training cell
reads the control and the faults "half of the batch left out, the mean
taken over the rest" (its steps train on the first half of each batch's
rows) and "a state left unchanged" (its steps at learning rate 0; it
reads 1 by `change_gap`'s and `lr_gap`'s measure, and the K-step call's
loss is read), on the rows and epochs a run checks.  A serving cell reads
the control's widest score gap over every clip of the pool, of which a
run's sample holds most.  The benchmark's own runs never run this; it
runs on the card at the cell's own size, as
`tests/test_portbench_controls.py` does.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import data, harness  # noqa: E402

# the control of each precision a cell states: the precision below it
CONTROL = {"float32": "control_tf32", "bfloat16": "control_fp8"}


def as_program(out: dict, k: int, b1: float, params0: dict) -> dict:
    """A reference run shaped as `drivers/train.py` reads the program."""
    from portbench.drivers.train import calls

    sizes, at, losses = calls(k), 0, []
    for n in sizes:
        losses.append(sum(out["losses"][at:at + n]) / n)
        at += n
    return {"losses": losses, "lr": out["lr_last"],
            "mu": {n: g.cpu() * (1 - b1)
                   for n, g in out["first_grad"].items()},
            "params_first": {n: v.cpu() for n, v in
                             out["params_steps"][0].items()},
            "params0": params0}


def train_readings(cell: dict, seed: int, device) -> dict:
    import torch

    from portbench.drivers import train as drv

    config, traffic = cell["config"], cell["traffic"]
    ref = harness.reference(config["reference"])
    b, k = traffic["batch"], traffic["steps_per_call"]
    d = config["data"]
    shape = (d["clip_len"], *d["frame_size"], d["channels"])
    clips, labels = data.seeded_clips(torch, traffic["clips"], shape,
                                      traffic["anomaly_share"], seed, device)
    rows = drv.checked_rows(traffic["clips"], b, k, seed)
    batches = [torch.from_numpy(clips[r]) for r in rows]
    labs = [torch.from_numpy(labels[r]) for r in rows]
    weights = ref.make_weights(config, seed, device)
    step_seed = seed % 0x7FFFFFFF + 1
    dtype = traffic["dtype"]
    base = ref.train_steps(config, weights, batches, labs, step_seed, device,
                           drv.calls(k), compute=dtype)
    params0 = {n: weights[n].detach().cpu() for n in base["names"]}
    b1 = config["optim"]["b1"]
    out = {}
    frozen = {**config, "optim": {**config["optim"], "lr": 0.0,
                                  "weight_decay": 0.0}}
    control = ({"tf32": True} if dtype == "float32" else
               {"compute": "fp8"})
    for name, conf, kw in (
            (CONTROL[dtype], config, control),
            ("fault_half_batch", config,
             {"drop_rows": lambda n: torch.arange(n // 2)}),
            ("fault_state_unchanged", frozen, {})):
        run = ref.train_steps(conf, weights, batches, labs, step_seed,
                              device, drv.calls(k),
                              **{"compute": dtype, **kw})
        out[name] = drv.compare(as_program(run, k, b1, params0), base, k, b1)
    return out


def serve_readings(cell: dict, seed: int, device) -> dict:
    import torch

    config, traffic = cell["config"], cell["traffic"]
    ref = harness.reference(config["reference"])
    d = config["data"]
    shape = (d["clip_len"], *d["frame_size"], d["channels"])
    pool, _ = data.seeded_clips(torch, traffic["pool"], shape, 0.0, seed,
                                device)
    clips = torch.from_numpy(pool)
    weights = ref.make_weights(config, seed, device)
    base = ref.scores(config, weights, clips, device)
    low = ref.scores(config, weights, clips, device, tf32=True)
    return {"control_tf32": {"score_gap": float((low - base).abs().max())}}


def readings(cell: dict, seed: int, device) -> dict:
    if cell["traffic"]["driver"] == "train":
        return train_readings(cell, seed, device)
    return serve_readings(cell, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    cell = harness.cell(args.workload)
    for seed in args.seeds:
        got = readings(cell, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, **{
            name: {**r, "correct": harness.passes(r, cell["limits"])}
            for name, r in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
