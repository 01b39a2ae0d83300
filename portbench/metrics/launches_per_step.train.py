"""Kernels on the card per train step in the traced slice (a captured
graph's kernel nodes each count, as the profiler records them)."""


def read(ctx, trace, out):
    if trace is None or not trace.counts.get("steps"):
        return None
    n = len(trace.kernels())
    return n / trace.counts["steps"] if n else None
