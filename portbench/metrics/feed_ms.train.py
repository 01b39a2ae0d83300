"""The host's time taking the next batch, per step, in the traced slice:
the summed ``trainer.feed`` ranges of `Trainer.train_epoch` (the device
clip cache's gather, or the prefetcher's hand-over) over the slice's
steps, in milliseconds.  Nothing where the program has no such range."""

from portbench.harness import load_module


def read(ctx, trace, out):
    return load_module("metrics", "_spans").per_step_ms(trace,
                                                        "trainer.feed")
