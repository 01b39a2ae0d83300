"""A traced slice of a window: torch.profiler over the CPU and the card,
reduced to plain intervals that the metric readers take.

`Trace` holds the slice's host-clock length, every device operation
(kernels, copies, fills, each with its activity) and every host event (the benchmark's spans, the
operators, the CUDA runtime calls) as (name, start, end) in seconds from
the slice's start, and the counts the driver adds (steps, clips, launch
counters).  `breakdown` gives the ten device operations that took most
time and the idle gaps of the card summed by what the host was doing.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("user_annotation", "cpu_op", "cuda_runtime",
                   "cuda_driver")

# the traced slice: this long, in the middle of the window
SLICE_S = 2.0


def slice_start(seconds: float) -> float:
    """When the traced slice starts, in seconds into a window of
    `seconds`."""
    return max(0.0, (seconds - SLICE_S) / 2)


Interval = Tuple[str, float, float]
DeviceOp = Tuple[str, float, float, str]  # (name, start, end, activity)


@dataclass
class Trace:
    window_s: float
    device: List[DeviceOp] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    counts: Dict[str, float] = field(default_factory=dict)

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        total, end = 0.0, None
        for _, s, e, _ in sorted(self.device, key=lambda x: x[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def kernels(self, match=lambda name: True) -> List[DeviceOp]:
        """The kernels (not copies or fills) whose name `match` accepts."""
        return [k for k in self.device if k[3] == "kernel" and match(k[0])]

    def gaps(self) -> List[Tuple[float, float]]:
        """The card's idle intervals inside the slice."""
        out, at = [], 0.0
        for _, s, e, _ in sorted(self.device, key=lambda x: x[1]):
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < self.window_s:
            out.append((at, self.window_s))
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = {}
        for name, s, e, _ in self.device:
            key = name[:120]
            by_op[key] = by_op.get(key, 0.0) + (e - s)
        by_host: Dict[str, float] = {}
        host = sorted(self.host, key=lambda x: x[1])
        active: List[Tuple[float, int]] = []  # heap of (end, index)
        nxt = 0
        for s, e in self.gaps():  # in time order
            mid = 0.5 * (s + e)
            while nxt < len(host) and host[nxt][1] <= mid:
                heapq.heappush(active, (host[nxt][2], nxt))
                nxt += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = (host[min((i for _, i in active),
                              key=lambda i: host[i][2] - host[i][1])][0][:120]
                     if active else "no host event")
            by_host[label] = by_host.get(label, 0.0) + (e - s)

        def first(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": first(by_op), "idle_gaps": first(by_host)}


def activity(ev) -> str:
    """A profiler event's activity: the event's own where this torch gives
    it, else from its device and name (a copy or a fill on the card is
    named ``Memcpy ...`` or ``Memset ...``)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    if "CUDA" not in str(ev.device_type()):
        return "cpu_op"
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


class Profiler:
    """torch.profiler over the CPU and CUDA between `start` and `stop`;
    `stop` returns the slice as a `Trace`."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = 0.0

    def prime(self) -> None:
        """One short session over a small operation, in set-up: the first
        session of a process sets up the card's tracing, which takes
        seconds; later ones start at once."""
        self.start()
        x = self.torch.ones(8, device="cuda" if
                            self.torch.cuda.is_available() else "cpu")
        (x + 1).sum().item()
        self.prof.__exit__(None, None, None)
        self.prof = None

    def start(self) -> None:
        tp = self.torch.profiler
        acts = [tp.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        self.prof = tp.profile(activities=acts)
        self.prof.__enter__()
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.start_ns = time.time_ns()

    def stop(self, counts: Optional[Dict[str, float]] = None) -> Trace:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        end_ns = self.start_ns + int(window * 1e9)
        self.prof.__exit__(None, None, None)
        trace = Trace(window_s=window, counts=dict(counts or {}))
        events = [(ev.name(), activity(ev), ev.start_ns(), ev.end_ns())
                  for ev in self.prof.profiler.kineto_results.events()]
        # a span (record_function) also shows on the card's timeline under
        # its own name; it is no operation of the card
        spans = {name for name, kind, _, _ in events
                 if kind in HOST_ACTIVITIES}
        for name, kind, s, e in events:
            if e < self.start_ns or s > end_ns:
                continue
            iv = (name, max(s - self.start_ns, 0) / 1e9,
                  (min(e, end_ns) - self.start_ns) / 1e9)
            if kind in DEVICE_ACTIVITIES and name not in spans:
                trace.device.append(iv + (kind,))
            elif kind in HOST_ACTIVITIES:
                trace.host.append(iv)
        self.prof = None
        return trace
