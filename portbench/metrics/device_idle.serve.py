"""The card's idle share of the traced slice of a serving window: one
minus the union of its operations' intervals over the slice, in %."""


def read(ctx, trace, out):
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
