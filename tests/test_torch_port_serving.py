"""The port's scorers, batching service and HTTP front-end on the CPU:
the scorers against `cvad_tpu`'s, the service's bucketing, chunking and
coalescing, and an HTTP round trip over the fixture checkpoint."""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # cvad_tpu's models
import jax.numpy as jnp  # noqa: E402

from cvad_tpu.evaluation.scoring import (  # noqa: E402
    make_family_d_score_fn as jax_score_fn)
from cvad_tpu.models import CausalAnomalyDetector as JaxDetector  # noqa: E402
from cvad_tpu_torch.config import FamilyDConfig  # noqa: E402
from cvad_tpu_torch.evaluation.http_service import (  # noqa: E402
    ScoringHTTPServer, service_from_path)
from cvad_tpu_torch.evaluation.scoring import (  # noqa: E402
    aggregate_frame_scores, make_family_d_bulk_score_fn,
    make_family_d_score_fn)
from cvad_tpu_torch.evaluation.serving import (  # noqa: E402
    BatchingServer, ClipScoringService)
from cvad_tpu_torch.runtime.checkpoint import (  # noqa: E402
    from_jax_family_d, load_torch_state_dict)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/dyn_parity_d/ours/best_improved_model.pth")


@pytest.fixture(scope="module")
def jax_variables():
    v = JaxDetector().init(jax.random.key(0), jnp.zeros((1, 8, 16, 16, 3)))
    return jax.tree_util.tree_map(np.asarray, v)


def _fake_score(seen):
    def fn(batch):
        seen.append((len(batch), batch.dtype))
        x = (batch.astype(np.float32) / 255.0 if batch.dtype == np.uint8
             else batch)
        return x.mean(axis=(1, 2, 3, 4)), np.zeros((len(batch), 4, 4))

    return fn


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_score_fn_matches_jax(jax_variables, dtype):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (5, 8, 16, 16, 3), dtype=np.uint8)
    clips = u8 if dtype == "uint8" else (u8 / 255.0).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        js, jadj = jax_score_fn(jax_variables)(clips)
    ps, padj = make_family_d_score_fn(from_jax_family_d(jax_variables),
                                      device="cpu")(clips)
    assert ps.shape == (5,) and padj.shape == (5, 16, 16)
    np.testing.assert_allclose(ps, js, atol=2e-4)
    np.testing.assert_allclose(padj, jadj, atol=2e-4)


def test_bulk_matches_per_batch_scorer(jax_variables):
    """Chunked bulk scorer with uint8 ingest == the per-batch scorer on the
    normalised floats (mirrors tests/test_serving.py's bulk test)."""
    state = from_jax_family_d(jax_variables)
    u8 = np.random.default_rng(0).integers(0, 256, (11, 8, 16, 16, 3),
                                           dtype=np.uint8)
    s0, a0 = make_family_d_score_fn(state, device="cpu")(
        (u8 / 255.0).astype(np.float32))
    bulk = make_family_d_bulk_score_fn(state, dtype="float32", batch=4,
                                       device="cpu")
    s1, a1 = bulk(u8)
    assert s1.shape == (11,) and a1.shape == (11, 16, 16)
    np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a1, a0, rtol=1e-5, atol=1e-6)
    s2, a2 = bulk(u8[:0])
    assert s2.shape == (0,) and a2.shape == (0, 16, 16)
    # the bf16 default stays near the f32 scores
    s3, _ = make_family_d_bulk_score_fn(state, batch=4, device="cpu")(u8)
    np.testing.assert_allclose(s3, s0, atol=2e-2)
    # an explicit config's dtype holds over `dtype`
    s4, _ = make_family_d_bulk_score_fn(state, FamilyDConfig(), batch=8,
                                        device="cpu")(u8)
    np.testing.assert_allclose(s4, s0, rtol=1e-5, atol=1e-6)


def test_empty_request_from_score_fn(jax_variables):
    s, adj = make_family_d_score_fn(from_jax_family_d(jax_variables),
                                    device="cpu")(
        np.zeros((0, 8, 16, 16, 3), np.float32))
    assert s.shape == (0,) and adj.shape == (0, 16, 16)


def test_aggregate_frame_scores():
    out = aggregate_frame_scores(np.array([0, 2]), np.array([1.0, 3.0]),
                                 clip_len=4, n_frames=7)
    np.testing.assert_allclose(out, [1, 1, 2, 2, 3, 3, 0])


@pytest.mark.parametrize("n,seen", [(3, [8]), (1, [1]), (40, [32, 8]),
                                    (70, [32, 32, 8]), (0, [])])
def test_bucket_padding_chunking_empty(n, seen):
    calls = []
    svc = ClipScoringService(_fake_score(calls), buckets=(8, 1, 32))
    clips = np.random.default_rng(n).uniform(0, 1, (n, 2, 4, 4, 1)).astype(
        np.float32)
    res = svc.score(clips)
    assert [c[0] for c in calls] == seen
    assert res.scores.shape == (n,)
    np.testing.assert_allclose(res.scores, clips.mean(axis=(1, 2, 3, 4)),
                               rtol=1e-6)
    if n:
        assert res.graphs.shape == (n, 4, 4)


def test_warmup_runs_every_bucket_per_dtype():
    calls = []
    svc = ClipScoringService(_fake_score(calls), buckets=(1, 4),
                             clip_shape=(2, 4, 4, 1))
    svc.warmup(dtypes=("float32", "uint8"))
    assert calls == [(1, np.float32), (4, np.float32), (1, np.uint8),
                     (4, np.uint8)]


def test_batching_server_coalesces_and_splits_dtypes():
    calls = []
    svc = ClipScoringService(_fake_score(calls), buckets=(16,))
    # a window long enough that all three submits land in it
    server = BatchingServer(svc, max_wait_ms=1000.0)
    rng = np.random.default_rng(1)
    reqs = [rng.uniform(0, 1, (2, 2, 4, 4, 1)).astype(np.float32),
            rng.uniform(0, 1, (3, 2, 4, 4, 1)).astype(np.float32),
            rng.integers(0, 256, (2, 2, 4, 4, 1), dtype=np.uint8)]
    results = [None] * len(reqs)

    def call(i):
        results[i] = server.submit(reqs[i], timeout=30)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    stats = server.stats()
    server.close()
    for clips, res in zip(reqs, results):
        x = (clips.astype(np.float32) / 255.0 if clips.dtype == np.uint8
             else clips)
        assert res.error is None
        np.testing.assert_allclose(res.scores, x.mean(axis=(1, 2, 3, 4)),
                                   rtol=1e-6)
    # one window: the two float32 requests share one device batch, the
    # uint8 one gets its own
    assert stats["requests_total"] == 3 and stats["clips_total"] == 7
    assert stats["batches_total"] == 2
    assert sorted(str(d) for _, d in calls) == ["float32", "uint8"]


def test_batching_server_reports_failed_batch():
    def boom(batch):
        raise ValueError("device batch failed")

    server = BatchingServer(ClipScoringService(boom, buckets=(4,)),
                            max_wait_ms=1.0)
    res = server.submit(np.zeros((2, 2, 4, 4, 1), np.float32), timeout=30)
    stats = server.stats()
    server.close()
    assert res.scores.shape == (0,) and "device batch failed" in res.error
    assert stats["errors_total"] == 1


def test_service_from_path_refuses_pth_of_a_c_e():
    """A `.pth` serves directly for families D and B only
    (tests/test_torch_port_train_b.py for B); for A, C and E it raises the
    `ValueError` that points to ``cli export``, as `cvad_tpu` does: those
    families serve from an exported scorer
    (tests/test_torch_port_export.py)."""
    for family in "ace":
        with pytest.raises(ValueError, match="cli export"):
            service_from_path(CKPT, family=family, device="cpu")


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip():
    svc = service_from_path(CKPT, buckets=(1, 4), device="cpu")
    srv = ScoringHTTPServer(svc, port=0)
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "buckets": [1, 4],
                          "clip_shape": [8, 64, 64, 3]}
        rng = np.random.default_rng(0)
        clips = rng.uniform(0, 1, (3, 8, 64, 64, 3)).astype(np.float32)
        direct_s, direct_a = make_family_d_score_fn(
            load_torch_state_dict(CKPT), device="cpu")(clips)

        buf = io.BytesIO()
        np.savez(buf, clips=clips)
        code, rep = _post(base + "/score", buf.getvalue(),
                          "application/octet-stream")
        assert code == 200 and rep["n"] == 3
        np.testing.assert_allclose(rep["scores"], direct_s, atol=1e-6)
        np.testing.assert_allclose(rep["graphs"], direct_a, atol=1e-6)

        code, rep = _post(base + "/score?graphs=0",
                          json.dumps({"clips": clips[:1].tolist()}).encode(),
                          "application/json")
        assert code == 200 and rep["n"] == 1 and rep["graphs"] is None
        np.testing.assert_allclose(rep["scores"], direct_s[:1], atol=1e-6)

        bad = io.BytesIO()
        np.save(bad, np.zeros((1, 8, 32, 32, 3), np.float32))
        code, rep = _post(base + "/score", bad.getvalue(),
                          "application/octet-stream")
        assert code == 400 and "clips must be" in rep["error"]
        code, rep = _post(base + "/score",
                          json.dumps({"clips": (clips[:1] * 255).tolist()})
                          .encode(), "application/json")
        assert code == 400 and "normalized" in rep["error"]

        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests_total"] == 2 and stats["batches_total"] >= 2
        assert stats["errors_total"] == 0
    finally:
        srv.close()
