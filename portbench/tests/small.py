"""Cells of `BENCHMARK.json` shrunk to sizes the CPU tests hold: family A
on (64, 96) frames of 4, fewer clips; the widths as
published."""

import copy

from portbench import harness


def small_cell(name: str) -> dict:
    c = copy.deepcopy(harness.cell(name))
    t, d = c["traffic"], c["config"]["data"]
    if c["config"]["family"] == "a":
        d.update(frame_size=[64, 96], clip_len=4)
    if t["driver"] == "train":
        t.update(batch=2 if c["config"]["family"] == "a" else 8,
                 clips=16 if c["config"]["family"] == "a" else 48)
        t["steps_per_call"] = min(t["steps_per_call"], 2)
    else:
        t.update(rate=30.0, pool=8, buckets=[1, 4], check_sample=6,
                 clients=8, drain_s=30.0, warmup_s=0.5)
    return c
