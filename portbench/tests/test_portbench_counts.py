"""The benchmark's operation and byte counts against the hand counts: the
reference's FLOPs a clip, K1's and K2's bounds as `PERF.md` §6 gives them
(NVIDIA H100 peaks: 67 TFLOP/s float32, 989 bf16, 3.35 TB/s)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.reference import family_a, family_d

K1 = harness.load_module("roofline", "k1")
K2 = harness.load_module("roofline", "k2")


def test_family_d_conv_flops():
    cfg = harness.cell("train-d-b256")["config"]
    model = family_d.Detector(cfg["model"]).to("meta")
    fe = model.feature_extractor
    x = torch.empty(1, 3, 8, 64, 64, device="meta")
    per_conv = []
    for conv in (fe.conv3d_1, fe.conv3d_2, fe.conv3d_3):
        with FlopCounterMode(display=False) as fc:
            x = conv(x)
        per_conv.append(fc.get_total_flops() / 1e6)
    assert per_conv == pytest.approx([21.2, 28.3, 14.2], abs=0.05)
    fwd = family_d.flops_per_clip(cfg, train=False)
    assert 63.7e6 < fwd < 64.5e6  # the convs and the small dense heads
    # training: conv1's input takes no gradient, the rest twice more
    assert family_d.flops_per_clip(cfg, train=True) == pytest.approx(
        fwd + 21.2e6 + 2 * (fwd - 21.2e6), rel=0.01)


def test_family_a_flops():
    cfg = harness.cell("train-a-b4-k4")["config"]
    fwd = family_a.flops_per_clip(cfg, train=False)
    assert fwd == pytest.approx(11.8e9, rel=0.02)
    train = family_a.flops_per_clip(cfg, train=True)
    assert 2.5 * fwd < train < 3.0 * fwd  # the frozen stem's conv once


@pytest.mark.parametrize("b,t,dtype,ms", [
    (256, 8, "float32", 0.0811), (256, 8, "bfloat16", 0.0351),
    (128, 64, "float32", 0.3245), (128, 64, "bfloat16", 0.1402)])
def test_k1_bound(b, t, dtype, ms):
    assert K1.bound_s(b, t, 64, 64, dtype) * 1e3 == pytest.approx(
        ms, rel=0.01)


def test_k2_bounds():
    rows = 256 * 0.95
    assert K2.forward_bound_s(256, 256, rows) * 1e3 == pytest.approx(
        0.00034, rel=0.02)
    assert K2.backward_bound_s(256, 256, rows) * 1e3 == pytest.approx(
        0.00069, rel=0.02)
