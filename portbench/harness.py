"""The benchmark's common parts: the registry (everything is found by the
name `BENCHMARK.json` gives it), the run's guards, the device record and
the result line.

Layout under ``portbench/``:

- ``configs/<config>.json``: one model configuration as it is run;
- ``traffic/<traffic>.json``: one traffic mix, the parameters the driver
  it names (``driver``) reads;
- ``limits/<cell>.json``: each number a cell compares, with its limit;
- ``drivers/<kind>.py``: the loop a window drives (``run(ctx)``);
- ``metrics/<metric>.py``: the reader of one per-layer metric
  (``read(ctx, trace)`` -> a number, or None where it finds nothing);
- ``reference/<family>.py``: the plain PyTorch reference of a family;
- ``roofline/<kernel>.py``: a kernel's operations and bytes at its launch
  shapes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names no run may hold: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "cvad_tpu")

# NVIDIA's published dense peaks of one H100 SXM (700 W)
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The `BENCHMARK.json` entry of workload `name`, with its
    configuration, traffic and limits read from their files."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"entry": entry, "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH / "traffic" /
                                 f"{entry['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]}


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench._{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(family: str) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{family}")


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among `modules` (default: the
    process's), each compared whole: ``cvad_tpu_torch`` is not
    ``cvad_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(n for n in FORBIDDEN if n in names)


def device_record(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def checks_record(readings: Dict[str, float], limits: Dict[str, float]
                  ) -> Dict[str, dict]:
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def passes(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit; a number that is missing or not
    finite fails."""
    import math

    return all(k in readings and math.isfinite(readings[k])
               and readings[k] <= lim for k, lim in limits.items())


def print_checks(checks: Dict[str, dict]) -> None:
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, tuple], device: dict,
                checks: Dict[str, dict], breakdown: Optional[dict] = None
                ) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
