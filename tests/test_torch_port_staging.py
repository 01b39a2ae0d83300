"""The serving path's staging on the card: `ClipScoringService` writes each
batch into a page-locked buffer that is reused, every batch crosses to
the card from it, and families A's and D's eager scorers give through
`BatchingServer` the scores that the concatenated and padded batch gives
them from pageable memory.  No JAX here: the file runs where flax is
absent.  CPU tests of the staging: tests/test_torch_port_serving.py."""

import os

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import FamilyAConfig
from cvad_tpu_torch.evaluation.http_service import FAMILY_CLIP_SHAPES
from cvad_tpu_torch.evaluation.scoring import make_score_fn
from cvad_tpu_torch.evaluation.serving import (BatchingServer,
                                               ClipScoringService)
from cvad_tpu_torch.models.registry import build_model
from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/dyn_parity_d/ours/best_improved_model.pth")
BUCKETS = (1, 8, 32)


def _state(family):
    """The fixture checkpoint for family D; seeded weights at the
    published widths for family A (gray frames)."""
    if family == "d":
        return load_torch_state_dict(CKPT)
    torch.manual_seed(0)
    model = build_model(FamilyAConfig(), in_channels=1)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["a", "d"])
def test_staged_batches_on_card(family):
    """Buckets 1, 8 and 32 through `BatchingServer`: each input is the
    pinned buffer's prefix, in one memory, every batch (the warm-up's too)
    counted as pinned, and the scores (D: and graphs) bit-equal to the
    same `score_fn` on the requests concatenated and padded in pageable
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn = make_score_fn(family, _state(family), device="cuda")
    shape = FAMILY_CLIP_SHAPES[family]
    seen = []

    def spy(batch):
        seen.append((torch.from_numpy(batch).is_pinned(),
                     batch.__array_interface__["data"][0]))
        return fn(batch)

    spy.device = fn.device
    svc = ClipScoringService(spy, buckets=BUCKETS, clip_shape=shape)
    svc.warmup(dtypes=("uint8",))
    warm = svc.pinned_batches_total  # `warmup` scores each bucket directly
    server = BatchingServer(svc, max_wait_ms=1.0)
    rng = np.random.default_rng(7)
    try:
        for n, b in ((1, 1), (5, 8), (20, 32)):
            clips = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
            res = server.submit(clips, timeout=300)
            assert res.error is None
            padded = np.concatenate(
                [clips, np.repeat(clips[-1:], b - n, axis=0)])
            want = _outputs(fn(padded))
            assert np.array_equal(res.scores, want[0][:n])
            if family == "d":
                assert np.array_equal(res.graphs, want[1][:n])
        stats = server.stats()
    finally:
        server.close()
    assert all(pinned for pinned, _ in seen)
    assert len({ptr for _, ptr in seen}) == 1
    assert warm == len(BUCKETS) and stats["batches_total"] == 3
    assert stats["pinned_batches_total"] - warm == stats["batches_total"]
