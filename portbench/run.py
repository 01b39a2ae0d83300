"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic
and limits from their files under ``portbench/``), runs the driver its
traffic names (set-up, the measured window, the check against the plain
reference), and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, each read by
``metrics/<name>.py`` from a profiled slice of the window), ``device``,
``breakdown`` (traced runs), and last ``checks``, each number compared
beside its limit (also the last lines of standard error).  Exits non-zero
with no result without as many CUDA cards as the cell asks for, or when
the process holds JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


class Context:
    """What a driver and a metric reader see of the run."""

    def __init__(self, torch, cell: dict, args, device, t_start: float,
                 fault=None):
        self.torch = torch
        self.cell = cell
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.seconds, self.trace = (args.seed, args.seconds,
                                               bool(args.trace))
        self.device = device
        self.t_start = t_start
        self.chips = cell["entry"]["chips"]
        self.fault = fault  # fault(kind, obj): a planted fault, in tests

    def mark(self, phase: str) -> None:
        """A set-up phase's end, in seconds from the process's start, on
        standard error."""
        print(f"portbench: {phase} at {time.perf_counter() - self.t_start:.2f} s",
              file=sys.stderr, flush=True)

    def fault_hook(self, kind: str, obj) -> None:
        if self.fault is not None:
            self.fault(kind, obj)

    def profiler(self):
        from portbench.trace import Profiler

        return Profiler(self.torch)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return harness.device_record(self.torch, self.chips)[
            "memory_peak_bytes"]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(ctx: Context) -> dict:
    """Run the cell's driver; the outcome with its metrics read."""
    out = harness.load_module("drivers", ctx.traffic["driver"]).run(ctx)
    trace = out.get("trace")
    if ctx.trace:
        metrics = {}
        for m in ctx.cell["per_layer"]:
            value = harness.load_module("metrics", m["name"]).read(
                ctx, trace, out)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
    else:
        metrics = {m["name"]: (out["end_to_end"][m["name"]], m["unit"])
                   for m in ctx.cell["end_to_end"]}
    out["metrics"] = metrics
    return out


def main(argv=None, device=None, cell=None, fault=None) -> int:
    """`device`, `cell` and `fault` are for the tests: they skip the look
    for a card, shrink the cell, or plant a fault in the program."""
    args = parse(argv)
    cell = cell or harness.cell(args.workload)
    import torch

    chips = cell["entry"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} available", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: the process holds {bad}", file=sys.stderr)
        return 3
    ctx = Context(torch, cell, args, torch.device(device), T_START, fault)
    ctx.mark("torch imported, card found")
    out = measure(ctx)
    if ctx.trace and out.get("trace") is None:
        print("portbench: the traced run took no trace", file=sys.stderr)
        return 4
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    limits = cell["limits"]
    checks = harness.checks_record(out["readings"], limits)
    correct = harness.passes(out["readings"], limits) and out["failed"] == 0
    if ctx.device.type == "cuda":
        dev = harness.device_record(torch, chips)
        dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    breakdown = None
    if ctx.trace:
        trace = out["trace"]
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        breakdown = trace.breakdown()
    print(json.dumps({"info": out["info"]}), file=sys.stderr, flush=True)
    harness.print_checks(checks)
    print(harness.result_line(correct, out["attempted"], out["failed"],
                              out["metrics"], dev, checks, breakdown),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
