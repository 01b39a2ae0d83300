"""The host's time issuing the train step, per step, in the traced slice:
the summed ``trainer.step`` ranges of `Trainer.train_epoch` (an eager
step's, or a K-step graph replay's, issue) over the slice's steps, in
milliseconds.  It includes back-pressure: where the card is behind, a
launch blocks until the device's queue has room, and the issue's time
grows with the device step.  Nothing where the program has no such
range."""

from portbench.harness import load_module


def read(ctx, trace, out):
    return load_module("metrics", "_spans").per_step_ms(trace,
                                                        "trainer.step")
