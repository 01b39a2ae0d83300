"""The knee of a serving cell: its window run at each of a few fixed rates
in one process, each a full run of the cell with only the rate changed.

    python3 portbench/sweep.py --workload NAME --seed N --seconds S \
        --rates R [R ...]

Prints, a rate, the run's result line after a line with the generator's
lateness, the 95th percentile of the first and the last fifth of the
requests and how long the last answers came after the window closed (a
backlog that grows shows as a last fifth far slower than the first).  The
knee is the highest rate whose 95th percentile stays within the cell's
limit with no growing backlog; the cell's traffic file then fixes its rate
at four fifths of it.  The benchmark's own runs never run this.
"""

import argparse
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import portbench.run as run  # noqa: E402
from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    for i, rate in enumerate(args.rates):
        cell = copy.deepcopy(harness.cell(args.workload))
        cell["traffic"]["rate"] = rate
        print(f"rate {rate}", flush=True)
        rc = run.main(["--workload", args.workload, "--seed",
                       str(args.seed + i), "--seconds", str(args.seconds),
                       "--trace", "0"], cell=cell)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
