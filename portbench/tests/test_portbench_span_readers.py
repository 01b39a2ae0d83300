"""The readers of the program's spans (`host_issue_ms.train`,
`feed_ms.train`, `epoch_end_ms.train`) on a synthetic trace with known
values, with nothing to read, and in a traced run of a small train cell
on the CPU, where the program's own ``trainer.*`` ranges feed them."""

import json
import types

import pytest

import portbench.run as run
from portbench import harness, trace
from portbench.tests.small import small_cell
from portbench.trace import Trace

NAMES = ("host_issue_ms.train", "feed_ms.train", "epoch_end_ms.train")


def read(name, tr):
    c = harness.cell("train-d-b256")
    ctx = types.SimpleNamespace(config=c["config"], traffic=c["traffic"],
                                cell=c)
    return harness.load_module("metrics", name).read(ctx, tr, {})


def span_trace():
    # 4 steps over 0.1 s in two epochs: feeds of 1 ms (the epochs' first
    # 3 ms), issues of 2 ms, epoch ends of 5 and 7 ms with their children,
    # and ranges of other names
    host = [("portbench.train_epoch", 0.0, 0.05),
            ("trainer.feed", 0.000, 0.003), ("trainer.step", 0.003, 0.005),
            ("trainer.feed", 0.010, 0.011), ("trainer.step", 0.011, 0.013),
            ("trainer.feed", 0.020, 0.021),
            ("trainer.epoch_end", 0.021, 0.026),
            ("trainer.fetch", 0.021, 0.024), ("aten::copy_", 0.021, 0.024),
            ("portbench.train_epoch", 0.05, 0.1),
            ("trainer.feed", 0.050, 0.053), ("trainer.step", 0.053, 0.055),
            ("trainer.feed", 0.060, 0.061), ("trainer.step", 0.061, 0.063),
            ("trainer.feed", 0.070, 0.071),
            ("trainer.epoch_end", 0.071, 0.078),
            ("trainer.history", 0.072, 0.077)]
    return Trace(window_s=0.1, device=[("k", 0.0, 0.02, "kernel")],
                 host=host, counts={"steps": 4, "clips": 1024})


def test_span_readers_on_known_values():
    tr = span_trace()
    assert read("host_issue_ms.train", tr) == pytest.approx(2.0)
    assert read("feed_ms.train", tr) == pytest.approx(10e-3 / 4 * 1e3)
    # 5 ms less its 3 ms fetch, and 7 ms (its history is its own time)
    assert read("epoch_end_ms.train", tr) == pytest.approx(4.5)
    # one K=4 call a dispatch: the issue's time over the steps it ran
    chunk = Trace(window_s=0.1, host=[("trainer.step", 0.0, 0.004)],
                  counts={"steps": 4})
    assert read("host_issue_ms.train", chunk) == pytest.approx(1.0)


@pytest.mark.parametrize("name", NAMES)
def test_span_readers_find_nothing(name):
    assert read(name, None) is None
    # the parent's program: the benchmark's own range, none of the program's
    bare = Trace(window_s=0.1, host=[("portbench.train_epoch", 0.0, 0.1)],
                 counts={"steps": 4})
    assert read(name, bare) is None
    if name != "epoch_end_ms.train":  # per step: no steps, no reading
        no_steps = span_trace()
        no_steps.counts = {}
        assert read(name, no_steps) is None


def test_traced_train_run_reads_the_program_spans(capsys, monkeypatch):
    """A traced run of the small D cell on the CPU: the three readers find
    the trainer's ranges in the slice, and the breakdown puts idle time
    down to them where the host was in one."""
    monkeypatch.setattr(trace, "SLICE_S", 0.2)
    rc = run.main(["--workload", "train-d-b256", "--seed", "4294967311",
                   "--seconds", "1", "--trace", "1"], device="cpu",
                  cell=small_cell("train-d-b256"))
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in NAMES:
        assert line["metrics"][name]["value"] > 0, name
        assert line["metrics"][name]["unit"] == "ms"
