"""The scorer's share of the card's peak over the window: the reference's
eval FLOPs of the requested clips (bucket padding not counted) over the
scorer's seconds (``score_seconds_total``) and NVIDIA's peak, in %."""

from portbench.harness import load_module


def read(ctx, trace, out):
    s = out["info"]["stats"]
    if not s["stats.score_seconds_total"]:
        return None
    common = load_module("metrics", "_common")
    flops = common.flops_per_clip(ctx, False) * s["stats.clips_total"]
    return 100.0 * flops / (s["stats.score_seconds_total"]
                            * common.peak_flops(ctx))
