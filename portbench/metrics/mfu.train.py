"""The whole train step's share of the card's peak: the reference's FLOPs
of one clip (forward and backward, `FlopCounterMode`) times the traced
run's clips per second outside its profiled slice (the profiler slows the
host), over NVIDIA's peak for the run's dtype, in %."""

from portbench.harness import load_module


def read(ctx, trace, out):
    rate = out.get("info", {}).get("unprofiled_clips_per_s")
    if not rate:
        return None
    common = load_module("metrics", "_common")
    return 100.0 * common.flops_per_clip(ctx, True) * rate / \
        common.peak_flops(ctx)
