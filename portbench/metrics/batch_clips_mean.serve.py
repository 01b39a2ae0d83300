"""Clips per device batch of the batching front end over the window:
``clips_total / batches_total`` of `BatchingServer.stats()` (the requested
clips, before bucket padding)."""


def read(ctx, trace, out):
    s = out["info"]["stats"]
    if not s["stats.batches_total"]:
        return None
    return s["stats.clips_total"] / s["stats.batches_total"]
