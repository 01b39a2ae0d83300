"""What the span readers share: the summed host time and the count of the
program's ranges of one name (`cvad_tpu_torch/runtime/metrics.py::span`)
in a traced slice."""


def total(trace, name):
    """(seconds, count) of the slice's host ranges named `name`; (0.0, 0)
    where there is no trace or the program has no such range."""
    if trace is None:
        return 0.0, 0
    times = [e - s for n, s, e in trace.host if n == name]
    return sum(times), len(times)


def per_step_ms(trace, name):
    """Milliseconds of `name`'s ranges over the slice's train steps, or
    None where the slice has none of them."""
    seconds, count = total(trace, name)
    steps = trace.counts.get("steps") if trace is not None else None
    if not count or not steps:
        return None
    return 1e3 * seconds / steps
