"""Host milliseconds per device batch of the scorer over the window:
``score_seconds_total / batches_total`` of `BatchingServer.stats()` (the
concatenate, padding, copies and forward of one coalesced batch)."""


def read(ctx, trace, out):
    s = out["info"]["stats"]
    if not s["stats.batches_total"]:
        return None
    return 1e3 * s["stats.score_seconds_total"] / s["stats.batches_total"]
