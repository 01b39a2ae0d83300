"""K2's share of its roofline in the traced slice, forward and backward:
the summed bound of its calls (`roofline/k2.py`, the rows the expected
share of normal pseudo-labels keeps) over its kernels' summed device time,
in %.  Nothing where K2 did not run."""

from portbench.harness import load_module


def read(ctx, trace, out):
    if trace is None:
        return None
    k2 = load_module("roofline", "k2")
    measured = sum(e - s for _, s, e, _ in
                   trace.kernels(lambda name: k2.NAME in name))
    fwd, bwd = (trace.counts.get(c, 0) for c in k2.COUNTERS)
    if measured <= 0 or not (fwd or bwd):
        return None
    b = ctx.traffic["batch"]
    n = ctx.config["model"]["causal_dim"] ** 2
    rows = b * (1 - ctx.config["loss"]["pseudo_anomaly_rate"])
    bound = (fwd * k2.forward_bound_s(b, n, rows)
             + bwd * k2.backward_bound_s(b, n, rows))
    return 100.0 * bound / measured
