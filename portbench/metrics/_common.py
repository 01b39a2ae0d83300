"""What the per-layer readers share: the peak of a run's dtype and the
FLOP count of one clip of its configuration."""

from portbench import harness


def peak_flops(ctx) -> float:
    return harness.PEAK_FLOPS[ctx.traffic.get("dtype", "float32")]


def flops_per_clip(ctx, train: bool) -> float:
    ref = harness.reference(ctx.config["reference"])
    return ref.flops_per_clip(ctx.config, train)
