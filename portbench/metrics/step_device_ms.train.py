"""The kernels' summed device time per train step in the traced slice,
in milliseconds."""


def read(ctx, trace, out):
    if trace is None or not trace.counts.get("steps"):
        return None
    busy = sum(e - s for _, s, e, _ in trace.kernels())
    return busy / trace.counts["steps"] * 1e3 if busy > 0 else None
