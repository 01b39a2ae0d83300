"""Each per-layer reader on a small synthetic trace with known values."""

import types

import pytest

from portbench import harness
from portbench.trace import Trace

CELLS = {"train": harness.cell("train-d-b256"),
         "serve": harness.cell("serve-a-cameras")}


def ctx(kind):
    c = CELLS[kind]
    return types.SimpleNamespace(config=c["config"], traffic=c["traffic"],
                                 cell=c)


def read(name, kind, trace, out=None):
    return harness.load_module("metrics", name).read(ctx(kind), trace,
                                                     out or {})


def train_trace():
    # 2 steps over 0.1 s: K1 twice (1 ms each), K2's forward and backward
    # kernels, two other kernels (60 ms of kernels in all), one copy; busy
    # 0.061 s of 0.1
    dev = [("tfold_conv1_f32_kernel", 0.000, 0.001, "kernel"),
           ("pairwise_tiles_kernel", 0.001, 0.0015, "kernel"),
           ("pairwise_backward_tiles_kernel", 0.0015, 0.002, "kernel"),
           ("cudnn_bwd", 0.002, 0.030, "kernel"),
           ("Memcpy HtoD", 0.030, 0.031, "gpu_memcpy"),
           ("tfold_conv1_f32_kernel", 0.050, 0.051, "kernel"),
           ("cudnn_bwd", 0.051, 0.080, "kernel")]
    return Trace(window_s=0.1, device=dev,
                 host=[("portbench.train_epoch", 0.0, 0.1),
                       ("aten::index_select", 0.031, 0.05)],
                 counts={"steps": 2, "clips": 512,
                         "launches.tfold_conv1": 2,
                         "launches.pairwise_l1_forward": 1,
                         "launches.pairwise_l1_backward": 1})


def test_train_readers():
    tr = train_trace()
    assert read("launches_per_step.train", "train", tr) == 3.0
    assert read("step_device_ms.train", "train", tr) == pytest.approx(30.0)
    assert read("device_idle.train", "train", tr) == pytest.approx(39.0)
    k1 = harness.load_module("roofline", "k1").bound_s(256, 8, 64, 64,
                                                       "float32")
    assert read("k1_roofline.train", "train", tr) == pytest.approx(
        100 * 2 * k1 / 0.002)
    k2 = harness.load_module("roofline", "k2")
    rows = 256 * 0.95
    want = 100 * (k2.forward_bound_s(256, 256, rows)
                  + k2.backward_bound_s(256, 256, rows)) / 0.001
    assert read("k2_roofline.train", "train", tr) == pytest.approx(want)
    flops = harness.reference("family_d").flops_per_clip(
        CELLS["train"]["config"], True)
    assert read("mfu.train", "train", tr, {
        "info": {"unprofiled_clips_per_s": 5120.0}}) == pytest.approx(
        100 * flops * 5120 / 67e12)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["cudnn_bwd", pytest.approx(0.057)]
    assert b["idle_gaps"] == [["portbench.train_epoch", pytest.approx(0.02)],
                              ["aten::index_select", pytest.approx(0.019)]]


def test_readers_find_nothing():
    empty = Trace(window_s=0.1, counts={"steps": 2, "clips": 512})
    for name in ("launches_per_step.train", "step_device_ms.train",
                 "k1_roofline.train", "k2_roofline.train",
                 "device_idle.train", "mfu.train"):
        assert read(name, "train", empty) is None, name
    assert read("device_idle.serve", "serve", None) is None


def test_serve_readers():
    stats = {"stats.requests_total": 100, "stats.clips_total": 100,
             "stats.batches_total": 4, "stats.errors_total": 0,
             "stats.score_seconds_total": 0.2}
    out = {"info": {"stats": stats}}
    assert read("batch_clips_mean.serve", "serve", None, out) == 25.0
    assert read("score_ms_mean.serve", "serve", None, out) == \
        pytest.approx(50.0)
    flops = harness.reference("family_a").flops_per_clip(
        CELLS["serve"]["config"], False)
    assert read("mfu.serve", "serve", None, out) == pytest.approx(
        100 * flops * 100 / (0.2 * 67e12))
    tr = Trace(window_s=1.0, device=[("k", 0.1, 0.4, "kernel")])
    assert read("device_idle.serve", "serve", tr, out) == pytest.approx(70)
