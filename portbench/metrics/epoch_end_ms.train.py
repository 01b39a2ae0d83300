"""The host's own time at an epoch's end in the traced slice: the mean
``trainer.epoch_end`` range of `Trainer.train_epoch` less its
``trainer.fetch`` child (the history, the scheduler's step and its lr),
in milliseconds.  The fetch is left out: its one ``.cpu()`` waits for the
card to run the steps still queued, so it measures the queue's depth, not
the epoch end.  Nothing where the program has no such range."""


def read(ctx, trace, out):
    if trace is None:
        return None
    ends = [(s, e) for n, s, e in trace.host if n == "trainer.epoch_end"]
    if not ends:
        return None
    fetches = [(s, e) for n, s, e in trace.host if n == "trainer.fetch"]
    own = sum(e - s - sum(max(0.0, min(e, fe) - max(s, fs))
                          for fs, fe in fetches)
              for s, e in ends)
    return 1e3 * own / len(ends)
