"""K1's share of its roofline in the traced slice: the summed bound of its
launches (`roofline/k1.py` at the cell's launch shape) over their summed
device time, in %.  Nothing where K1 did not run."""

from portbench.harness import load_module


def read(ctx, trace, out):
    if trace is None:
        return None
    k1 = load_module("roofline", "k1")
    measured = sum(e - s for _, s, e, _ in
                   trace.kernels(lambda name: k1.NAME in name))
    launches = trace.counts.get(k1.COUNTER, 0)
    if measured <= 0 or not launches:
        return None
    d = ctx.config["data"]
    bound = k1.bound_s(ctx.traffic["batch"], d["clip_len"],
                       *d["frame_size"], ctx.traffic["dtype"],
                       cin=d["channels"],
                       cout=ctx.config["model"]["conv_channels"][0])
    return 100.0 * launches * bound / measured
