"""The port's spans and counters on the CPU: `runtime/metrics.py::span`,
the batching server's counters (`BatchingServer.stats`), the worker's
``serving.*`` ranges and the trainer's ``trainer.*`` ranges as
`torch.profiler` records them, and `profile_trace` recording a thread
that was started before the profile."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from cvad_tpu_torch.config import preset
from cvad_tpu_torch.data.batcher import BatchLoader
from cvad_tpu_torch.data.datasets import SyntheticClipDataset
from cvad_tpu_torch.evaluation.serving import (BatchingServer,
                                               ClipScoringService,
                                               clip_scorer)
from cvad_tpu_torch.runtime import metrics
from cvad_tpu_torch.runtime.metrics import TRACE_NAME, profile_trace, span
from cvad_tpu_torch.train.engine import Trainer

CLIP = (2, 4, 4, 1)


def _mean_scorer(calls=None, hold_s=0.0, started=None):
    """A fake device scorer: the mean of each clip; it notes each batch's
    size, signals `started` and holds the batch `hold_s` seconds."""
    def fn(batch):
        if started is not None:
            started.set()
        if calls is not None:
            calls.append(len(batch))
        time.sleep(hold_s)
        return batch.astype(np.float32).mean(axis=(1, 2, 3, 4))

    return fn


def _clips(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + CLIP).astype(
        np.float32)


def _every_thread():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))


def _spans(prof, prefix):
    """(name, start_ns, end_ns, thread) of each recorded range whose name
    starts with `prefix`, in time order."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefix)]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_padding_counts_exactly():
    """3 clips into bucket 8 add 5 padded clips; a full bucket adds none;
    a request past the largest bucket is chunked and each chunk's padding
    counts."""
    calls = []
    svc = ClipScoringService(_mean_scorer(calls), buckets=(1, 8),
                             clip_shape=CLIP)
    server = BatchingServer(svc, max_wait_ms=1.0)
    try:
        res = server.submit(_clips(3), timeout=30)
        assert res.error is None and res.scores.shape == (3,)
        s = server.stats()
        assert s["padded_clips_total"] == 5 and s["clips_total"] == 3
        assert s["host_prep_seconds_total"] > 0
        assert s["host_prep_seconds_total"] <= s["score_seconds_total"]
        server.submit(_clips(8, 1), timeout=30)
        assert server.stats()["padded_clips_total"] == 5
        server.submit(_clips(11, 2), timeout=30)  # 8 + 3 padded to 8
        s = server.stats()
    finally:
        server.close()
    assert calls == [8, 8, 8, 8]
    assert s["padded_clips_total"] == 10 and s["clips_total"] == 22
    assert s["requests_total"] == 3 and s["batches_total"] == 3
    direct = svc.score(_clips(3))
    assert direct.scores.shape == (3,) and svc.padded_clips_total == 15


def test_queue_wait_counts_a_request_behind_a_running_batch():
    """A request that arrives while a 50 ms batch runs waits for it: the
    queue wait grows by at least 40 ms; the first request's own wait is
    the coalescing window's 1 ms and its dequeue."""
    started = threading.Event()
    svc = ClipScoringService(_mean_scorer(hold_s=0.05, started=started),
                             buckets=(1,), clip_shape=CLIP)
    server = BatchingServer(svc, max_wait_ms=1.0)
    results = [None, None]

    def call(i):
        results[i] = server.submit(_clips(1, i), timeout=30)

    first = threading.Thread(target=call, args=(0,))
    second = threading.Thread(target=call, args=(1,))
    try:
        first.start()
        assert started.wait(30)
        second.start()
        first.join(timeout=30)
        second.join(timeout=30)
        assert not first.is_alive() and not second.is_alive()
        s = server.stats()
    finally:
        server.close()
    assert all(r is not None and r.error is None for r in results)
    assert s["requests_total"] == 2 and s["batches_total"] == 2
    assert s["queue_wait_seconds_total"] >= 0.04
    assert s["padded_clips_total"] == 0


def test_failed_batch_counts_its_wait():
    def boom(batch):
        raise ValueError("device batch failed")

    server = BatchingServer(ClipScoringService(boom, buckets=(4,)),
                            max_wait_ms=1.0)
    try:
        res = server.submit(_clips(2), timeout=30)
        s = server.stats()
    finally:
        server.close()
    assert "device batch failed" in res.error
    assert s["errors_total"] == 1 and s["queue_wait_seconds_total"] > 0


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(int(np.prod(CLIP)), 1)

    def forward(self, x):
        return self.lin(x.flatten(1)).reshape(-1)


def test_worker_spans_under_an_all_thread_profile():
    """The worker started before the profile; with every thread recorded
    its ranges appear in its own thread, in the order of a batch's life,
    the model's operators inside ``serving.forward``."""
    svc = ClipScoringService(clip_scorer(_Tiny().eval(),
                                         torch.device("cpu")),
                             buckets=(8,), clip_shape=CLIP)
    server = BatchingServer(svc, max_wait_ms=1.0)
    try:
        svc.warmup()
        with _every_thread() as prof:
            res = server.submit(_clips(3), timeout=30)
    finally:
        server.close()
    assert res.error is None and res.scores.shape == (3,)
    got = _spans(prof, "serving.")
    names = [s[0] for s in got]
    assert names == ["serving.coalesce", "serving.concatenate",
                     "serving.pad", "serving.copy_in", "serving.forward",
                     "serving.copy_out", "serving.reply"]
    assert len({s[3] for s in got}) == 1
    assert threading.get_native_id() not in {s[3] for s in got}
    for a, b in zip(got, got[1:]):  # one after the other, none nested
        assert a[2] <= b[1]
    forward = got[names.index("serving.forward")]
    ops = [s for s in _spans(prof, "aten::") if s[3] == forward[3]]
    assert any(s[0] in ("aten::linear", "aten::addmm") and
               _inside(s, forward) for s in ops)


def test_profile_trace_records_a_thread_started_before_it(tmp_path):
    """`profile_trace` (``train --profile-dir``) records every thread: the
    batching worker's ranges are in its Chrome trace."""
    svc = ClipScoringService(_mean_scorer(), buckets=(4,), clip_shape=CLIP)
    server = BatchingServer(svc, max_wait_ms=1.0)
    try:
        with profile_trace(str(tmp_path), "cpu"):
            server.submit(_clips(2), timeout=30)
    finally:
        server.close()
    events = json.loads((tmp_path / TRACE_NAME).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"serving.coalesce", "serving.pad", "serving.reply"} <= names


def _trainer(tmp_path, steps_per_call, log_every=10**9):
    cfg = preset("family_d")
    cfg = cfg.replace(
        data=cfg.data.replace(batch_size=8, frame_size=(16, 16),
                              transfer_dtype="uint8"),
        train=cfg.train.replace(num_epochs=2, eval_every=10**9,
                                save_interval=0, log_every=log_every,
                                out_dir=str(tmp_path), device_cache="on",
                                steps_per_call=steps_per_call))
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    loader = BatchLoader(SyntheticClipDataset(cfg.data, n=19, split="Train"),
                         8, shuffle=True, seed=3, transfer_dtype="uint8")
    return trainer, loader


@pytest.mark.parametrize("k,dispatches", [(1, 3), (2, 2)])
def test_trainer_spans(tmp_path, k, dispatches):
    """One ``trainer.step`` a dispatch (a single step, or a K-step chunk:
    19 clips in batches of 8, 8 and 3), one ``trainer.feed`` a dispatch
    and one for the feed's end, one ``trainer.epoch_end`` an epoch with
    its fetch, history and schedule inside it, after every step."""
    trainer, loader = _trainer(tmp_path, k)
    trainer.train_epoch(loader, 1)  # builds the clip cache
    with _every_thread() as prof:
        trainer.train_epoch(loader, 2)
    got = _spans(prof, "trainer.")
    count = {n: sum(s[0] == n for s in got) for n in {s[0] for s in got}}
    assert count == {"trainer.feed": dispatches + 1,
                     "trainer.step": dispatches, "trainer.epoch_end": 1,
                     "trainer.fetch": 1, "trainer.history": 1,
                     "trainer.schedule": 1}
    end = next(s for s in got if s[0] == "trainer.epoch_end")
    for name in ("trainer.fetch", "trainer.history", "trainer.schedule"):
        assert _inside(next(s for s in got if s[0] == name), end)
    steps = [s for s in got if s[0] == "trainer.step"]
    assert all(s[2] <= end[1] for s in steps)
    feeds = [s for s in got if s[0] == "trainer.feed"]
    for feed, step in zip(feeds, steps):  # feed, then its step
        assert feed[2] <= step[1]


def test_trainer_log_line_after_its_fetch(tmp_path):
    """With a log line every step, each is a ``trainer.log`` range and
    carries a positive ``steps_per_s``, timed after its fetch."""
    trainer, loader = _trainer(tmp_path, 1, log_every=1)
    trainer.train_epoch(loader, 1)
    with _every_thread() as prof:
        trainer.train_epoch(loader, 2)
    assert sum(s[0] == "trainer.log" for s in _spans(prof, "trainer.")) == 3
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    rates = [r["steps_per_s"] for r in lines if r["kind"] == "train_batch"]
    assert len(rates) == 6 and all(r > 0 for r in rates)


def test_span_without_a_profiler_enters_no_record_function(monkeypatch,
                                                           tmp_path):
    """With no profiler, neither the trainer nor the batching server
    enters a `record_function`; under one, `span` does."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with span("x"):
        pass
    trainer, loader = _trainer(tmp_path, 1)
    trainer.train_epoch(loader, 1)
    server = BatchingServer(ClipScoringService(_mean_scorer(),
                                               buckets=(4,), clip_shape=CLIP),
                            max_wait_ms=1.0)
    try:
        server.submit(_clips(3), timeout=30)
    finally:
        server.close()
    assert entered == []
    monkeypatch.setattr(metrics._autograd_profiler, "_is_profiler_enabled",
                        True)
    with span("on"):
        pass
    assert entered == ["on"]
