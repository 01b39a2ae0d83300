"""Reachability of the CUDA devices, asked in a disposable process.

Port of `cvad_tpu/runtime/doctor.py::probe_devices` (:31-50): a driver or
device that hangs hangs any process that initialises CUDA, so ``cli
doctor`` asks a child process with a hard timeout and survives either way.
This module imports nothing of torch itself.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Tuple

_PROBE = """
import json, torch
n = torch.cuda.device_count() if torch.cuda.is_available() else 0
print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                  "devices": [{"index": i,
                               "name": torch.cuda.get_device_name(i),
                               "capability": list(
                                   torch.cuda.get_device_capability(i))}
                              for i in range(n)]}))
"""


def probe_devices(timeout_s: float) -> Tuple[str, object]:
    """``torch.cuda``'s device count, names and capabilities in a child
    process with a hard timeout.

    Returns ``(status, detail)``: ``"ok"`` with one dict a device,
    ``"error"`` with the stderr tail or, when the child sees no CUDA
    device, its torch and CUDA versions, or ``"timeout"`` with a hint.
    """
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return "timeout", (f"CUDA device discovery did not answer within "
                           f"{timeout_s:.0f}s (a hung driver or device?)")
    if r.returncode != 0:
        return "error", r.stderr[-300:]
    seen = json.loads(r.stdout.strip().splitlines()[-1])
    if not seen["devices"]:
        return "error", (f"torch {seen['torch']} (CUDA {seen['cuda']}) sees "
                         "no CUDA device; the port runs on the CPU only "
                         "with --device cpu")
    return "ok", seen["devices"]
