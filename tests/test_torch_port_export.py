"""Export and serving of every family's scorer on the CPU: each family's
`torch.export` artefact, saved, loaded and scored at batch 1, 3 and 8,
against the port's eager scorer (the kernels' custom ops in its graph where
the CPU route reaches them); families D and B against `cvad_tpu`'s
``jax.export`` blobs on the same weights; `torch.library.opcheck` on the
four ops; family D's fixed-order 3-D pool; `service_from_path`'s sniffing;
an HTTP round trip from a family-A artefact; ``cli export`` and ``serve``.
The `cuda`-marked twins run the same on the card, with each kernel's
launch count through an artefact equal to the eager scorer's."""

import io
import json
import os
import sys
import threading
import urllib.request
import zipfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvad_tpu_torch import cli
from cvad_tpu_torch.config import (FamilyAConfig, FamilyBConfig,
                                   FamilyCConfig, FamilyDConfig,
                                   FamilyEConfig)
from cvad_tpu_torch.evaluation import http_service, serving
from cvad_tpu_torch.evaluation.scoring import make_score_fn
from cvad_tpu_torch.models import family_d
from cvad_tpu_torch.models.family_b import MemoryBankState
from cvad_tpu_torch.models.layers import adaptive_avg_pool3d
from cvad_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from cvad_tpu_torch.ops import pallas_s2d
from cvad_tpu_torch.runtime.checkpoint import load_torch_state_dict
from cvad_tpu_torch.runtime.device import no_tf32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs/dyn_parity_d/ours/best_improved_model.pth")
B_NARROW = dict(conv_channels=(8, 16, 32, 32), latent_dim=16, lstm_hidden=16)
B_ATTN = dict(conv_channels=(8, 16, 32, 32), latent_dim=32, attn_heads=2,
              attn_layers=1, temporal_encoder="attention")
EXPORTERS = serving.EXPORTERS

# name: (family, model config, clip (T, H, W, C), the kernel ops a CPU
# artefact's graph holds); families at small widths, D on the fixture
CASES = {
    "d": ("d", FamilyDConfig(), (8, 64, 64, 3), {"tfold_conv1"}),
    "d_s2d": ("d", FamilyDConfig(conv_group_impl="s2d", conv1_mode="tfold"),
              (16, 32, 32, 3), {"s2d_group_conv"}),
    "b": ("b", FamilyBConfig(**B_NARROW), (8, 64, 64, 1),
          {"memory_min_cosine"}),
    "b_attn": ("b", FamilyBConfig(**B_ATTN), (16, 64, 64, 1),
               {"memory_min_cosine"}),
    "c": ("c", FamilyCConfig(), (8, 32, 32, 1), set()),
    "a": ("a", FamilyAConfig(backbone_channels=(8, 8, 8, 16, 16)),
          (4, 32, 48, 1), set()),
    "e": ("e", FamilyEConfig(conv_channels=(8, 16)), (8, 32, 32, 3), set()),
}
# on the card the B-attention case runs K6 (T a multiple of 128, head 128)
CARD_B_ATTN = dict(conv_channels=(8, 16, 32, 32), latent_dim=128,
                   attn_heads=1, attn_layers=1, temporal_encoder="attention")


def _state(name: str, cfg) -> dict:
    """The fixture for family D; a seeded model otherwise, family B's bank
    filled with 300 seeded rows."""
    if name.startswith("d"):
        return load_torch_state_dict(CKPT)
    family = CASES[name][0]
    model = build_model(cfg, **({"in_channels": 1} if family == "a" else {}))
    if family == "b":
        m, d = model.normal_memory.shape
        bank = np.random.default_rng(3).normal(size=(m, d)).astype(
            np.float32)
        model.set_memory_bank(MemoryBankState(
            torch.from_numpy(bank), torch.tensor(300 % m, dtype=torch.int32),
            torch.tensor(300, dtype=torch.int32)))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def artefacts():
    """Exported CPU artefacts by case, made and loaded once: (blob, the
    loaded scorer, state, cfg)."""
    made = {}

    def get(name: str):
        if name not in made:
            family, cfg, clip, _ = CASES[name]
            state = _state(name, cfg)
            blob = EXPORTERS[family](state, clip_shape=clip, cfg=cfg,
                                     device="cpu")
            made[name] = (blob, serving.load_scorer(blob), state, cfg)
        return made[name]

    return get


def _kernel_ops(fn) -> set:
    """The kernels' custom ops in a loaded scorer's graph."""
    return {str(n.target).split(".")[1] for n in fn.program.graph.nodes
            if str(n.target).startswith("cvad_torch.")}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _check_against_eager(family, fn, state, cfg, clip, device, atol):
    """A loaded artefact at batch 1, 3 and 8 (float32, and uint8 at 3)
    against the eager scorer (scores) and the `ScorerModule` it was traced
    from, which the eager scorer calls (every output)."""
    assert fn.clip_shape == clip and fn.device.type == device
    eager = make_score_fn(family, state, cfg=cfg, device=device)
    module = serving.scorer_module(family, state, cfg, device=device)
    rng = np.random.default_rng(1)
    for b in (1, 3, 8):
        x = rng.uniform(0, 1, (b,) + clip).astype(np.float32)
        got = _outputs(fn(x))
        with torch.inference_mode(), no_tf32():
            want = _outputs(module(torch.from_numpy(x).to(device)))
        ref = _outputs(eager(x))
        assert len(got) == len(want)
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=atol)
        for g, w in zip(got, want):
            w = w.cpu().numpy()
            assert g.shape[0] == b and g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    u8 = rng.integers(0, 256, (3,) + clip, dtype=np.uint8)
    np.testing.assert_allclose(_outputs(fn(u8))[0], _outputs(eager(u8))[0],
                               rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_artefact_matches_eager_scorer(artefacts, name):
    """Exported on the CPU, saved, loaded with `load_scorer`: every output
    within 1e-6 of the eager scorer at batch 1, 3 and 8 (the batch is a
    dynamic dimension), uint8 clips divided by 255; the graph holds the
    custom ops of the kernels the CPU route reaches."""
    blob, fn, state, cfg = artefacts(name)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        assert http_service.artefact_kind(z) == "artefact"
    assert serving.artefact_meta(blob) == {"device": "cpu",
                                           "family": CASES[name][0]}
    family, _, clip, ops = CASES[name]
    assert _kernel_ops(fn) == ops
    _check_against_eager(family, fn, state, cfg, clip, "cpu", 1e-6)


def test_family_d_artefact_matches_jax():
    """The port's family-D artefact against `cvad_tpu`'s ``jax.export``
    blob on the same weights (16x16 frames: conv3's (2, 2, 2) output takes
    the fixed-order pool), at the scorer parity tolerance of
    test_torch_port_serving.py."""
    pytest.importorskip("flax")
    import jax
    from cvad_tpu.evaluation import serving as jax_serving

    from cvad_tpu_torch.runtime.checkpoint import to_jax_family_d

    state = family_d.CausalAnomalyDetector().state_dict()
    with jax.default_matmul_precision("highest"):
        ref_fn = jax_serving.load_scorer(jax_serving.export_scorer(
            to_jax_family_d(state), clip_shape=(8, 16, 16, 3),
            platforms=("cpu",)))
    fn = serving.load_scorer(serving.export_scorer(
        state, clip_shape=(8, 16, 16, 3), device="cpu"))
    u8 = np.random.default_rng(0).integers(0, 256, (5, 8, 16, 16, 3),
                                           dtype=np.uint8)
    for clips in (u8, (u8 / 255.0).astype(np.float32)):
        (s, adj), (js, jadj) = fn(clips), ref_fn(clips)
        np.testing.assert_allclose(s, js, atol=2e-4)
        np.testing.assert_allclose(adj, jadj, atol=2e-4)


def test_family_b_artefact_matches_jax(tmp_path):
    """The port's family-B artefact (LSTM, the bank baked in) against
    `cvad_tpu`'s blob from the same `.pth` read by `import_torch_family_b`,
    at the scorer parity tolerance."""
    pytest.importorskip("flax")
    import jax
    from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig
    from cvad_tpu.evaluation import serving as jax_serving
    from cvad_tpu.models import MemoryVideoAutoEncoder as JaxAutoEncoder
    from cvad_tpu.runtime.checkpoint import import_torch_family_b

    cfg = CASES["b"][1]
    state = _state("b", cfg)
    path = tmp_path / "b.pth"
    torch.save({"model_state_dict": state}, path)
    variables, memory = import_torch_family_b(str(path))
    with jax.default_matmul_precision("highest"):
        ref_fn = jax_serving.load_scorer(jax_serving.export_family_b_scorer(
            variables, memory, clip_shape=(8, 64, 64, 1),
            model=JaxAutoEncoder(JaxFamilyBConfig(**B_NARROW)),
            platforms=("cpu",)))
    fn = serving.load_scorer(serving.export_family_b_scorer(
        state, clip_shape=(8, 64, 64, 1), cfg=cfg, device="cpu"))
    clips = np.random.default_rng(2).uniform(0, 1, (4, 8, 64, 64, 1)).astype(
        np.float32)
    np.testing.assert_allclose(fn(clips), ref_fn(clips), atol=2e-4)


def _op_inputs(name: str, device: str) -> tuple:
    """Inputs of each kernel's op at small shapes, made from a seed."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(device)

    if name == "tfold_conv1":
        return (r(2, 3, 8, 16, 16), r(16, 3, 3, 3, 3))
    if name == "memory_min_cosine":
        return (r(5, 32), r(20, 32),
                torch.tensor(12, dtype=torch.int32, device=device))
    if name == "s2d_group_conv":
        xg = pallas_s2d.s2d_fold_groups(r(2, 16, 16, 16, 3), 8)
        wdp = pallas_s2d._pad_wd(pallas_s2d.s2d_fold_kernel(
            r(3, 3, 3, 3, 16), 8))
        return (xg.contiguous(), wdp.contiguous(), 8, 3, 16)
    qkv = [r(2, 1, 128, 128) for _ in range(3)]
    return (*qkv, True, 128 ** -0.5)


OPS = ("tfold_conv1", "memory_min_cosine", "s2d_group_conv",
       "flash_attention_forward")


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    """`torch.library.opcheck` (schema, autograd registration, the fake
    against the real op, AOT dispatch with dynamic shapes) on CPU
    tensors."""
    op = getattr(torch.ops.cvad_torch, name).default
    torch.library.opcheck(op, _op_inputs(name, "cpu"))


def test_adaptive_avg_pool3d_matches_torch():
    """(2, 2, 2) -> (4, 4, 4), conv3's output at 16x16 frames: the
    fixed-order pool equals `F.adaptive_avg_pool3d` (each window one cell)
    and its gradient within 1e-6; odd sizes within float32 rounding."""
    x = torch.randn(3, 64, 2, 2, 2, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y, ref = adaptive_avg_pool3d(x, (4, 4, 4)), F.adaptive_avg_pool3d(
        x, (4, 4, 4))
    assert torch.equal(y, ref)
    ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    (gy,), (gr,) = (torch.autograd.grad(o, x, ct) for o in (y, ref))
    np.testing.assert_allclose(gy.numpy(), gr.numpy(), rtol=0, atol=1e-6)
    odd = torch.randn(2, 4, 3, 5, 7)
    np.testing.assert_allclose(adaptive_avg_pool3d(odd, (4, 4, 4)).numpy(),
                               F.adaptive_avg_pool3d(odd, (4, 4, 4)).numpy(),
                               rtol=0, atol=1e-6)


def test_family_d_takes_fixed_order_pool_only_where_shared(monkeypatch):
    """`family_d.pool3d` takes the fixed-order pool where more than two
    windows share an input cell ((2, 2, 2) at 16x16 frames) and
    `F.adaptive_avg_pool3d` on the main paths ((2, 8, 8) at 64x64, T=8;
    (16, 8, 8) at T=64); the model's forward at 16x16 goes through it."""
    calls = []

    def counted(x, out):
        calls.append(tuple(x.shape[2:]))
        return adaptive_avg_pool3d(x, out)

    monkeypatch.setattr(family_d, "adaptive_avg_pool3d", counted)
    for shape in ((2, 8, 8), (16, 8, 8), (2, 4, 4)):
        family_d.pool3d(torch.zeros((1, 4) + shape), (4, 4, 4))
    assert calls == []
    family_d.pool3d(torch.zeros(1, 4, 2, 2, 2), (4, 4, 4))
    assert calls == [(2, 2, 2)]
    model = family_d.CausalAnomalyDetector().eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, 8, 16, 16))
    assert calls == [(2, 2, 2)] * 2


def test_service_from_path_sniffs_members(artefacts, tmp_path):
    """A `.pth` (zip or legacy pickle) and an artefact are told apart by
    their zip members, not their first bytes (both zips start 'PK'); an
    artefact serves at its own clip shape whatever `family` says; empty,
    garbage and foreign zip files raise `ValueError`."""
    blob = artefacts("c")[0]
    art = tmp_path / "c.pt2"
    art.write_bytes(blob)
    assert blob[:2] == open(CKPT, "rb").read(2) == b"PK"
    assert http_service.checkpoint_kind(CKPT) == "pth"
    assert http_service.checkpoint_kind(str(art)) == "artefact"
    legacy = tmp_path / "legacy.pth"
    torch.save({"w": torch.zeros(2)}, legacy,
               _use_new_zipfile_serialization=False)
    assert http_service.checkpoint_kind(str(legacy)) == "pth"
    svc = http_service.service_from_path(str(art), family="d",
                                         buckets=(1, 4))
    assert svc.clip_shape == (8, 32, 32, 1)
    assert svc.score(np.zeros((2, 8, 32, 32, 1), np.float32)).scores.shape \
        == (2,)
    (tmp_path / "empty").write_bytes(b"")
    (tmp_path / "garbage").write_bytes(b"not a checkpoint at all")
    with zipfile.ZipFile(tmp_path / "foreign.zip", "w") as z:
        z.writestr("readme.txt", "hello")
    for name, match in (("empty", "empty file"), ("garbage", "not a torch"),
                        ("foreign.zip", "not a torch")):
        with pytest.raises(ValueError, match=match):
            http_service.service_from_path(str(tmp_path / name))


def test_http_round_trip_from_family_a_artefact(artefacts):
    """`cvad_tpu`'s reply for the same blob: ``{"scores", "graphs", "n"}``
    with the detections as "graphs" (`ClipScoringService.score` takes the
    second output); both within 1e-6 of `load_scorer`; ``?graphs=0``
    drops them."""
    fn = artefacts("a")[1]
    srv = http_service.ScoringHTTPServer(serving.ClipScoringService(
        fn, buckets=(1, 4), clip_shape=fn.clip_shape), port=0)
    host, port = srv.start()
    clips = np.random.default_rng(5).uniform(0, 1, (3, 4, 32, 48, 1)).astype(
        np.float32)
    buf = io.BytesIO()
    np.savez(buf, clips=clips)
    try:
        replies = []
        for query in ("", "?graphs=0"):
            req = urllib.request.Request(
                f"http://{host}:{port}/score{query}", data=buf.getvalue(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=120) as r:
                replies.append(json.loads(r.read()))
    finally:
        srv.close()
    scores, detections, _ = fn(clips)
    rep, bare = replies
    assert set(rep) == {"scores", "graphs", "n"} and rep["n"] == 3
    np.testing.assert_allclose(rep["scores"], scores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rep["graphs"]), detections,
                               rtol=0, atol=1e-6)
    assert bare["graphs"] is None and bare["n"] == 3


def test_load_scorer_needs_no_model_code(artefacts, monkeypatch):
    """`load_scorer` loads and runs an artefact with every model, train and
    scorer module of the port made unimportable (``chip_smoke.py`` phase
    ``export`` does the same in a fresh process on the card)."""
    blob = artefacts("d")[0]
    blocked = [m for m in list(sys.modules)
               if m.startswith(("cvad_tpu_torch.models",
                                "cvad_tpu_torch.train",
                                "cvad_tpu_torch.evaluation.scoring"))]
    assert "cvad_tpu_torch.models.family_d" in blocked
    for name in blocked:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import cvad_tpu_torch.models.family_d  # noqa: F401
    fn = serving.load_scorer(blob)
    s, adj = fn(np.zeros((2,) + fn.clip_shape, np.float32))
    assert s.shape == (2,) and adj.shape == (2, 16, 16)


def test_cuda_artefact_raises_without_cuda(artefacts):
    """An artefact traced on the card does not fall back to the CPU on a
    host without CUDA: `load_scorer` raises `resolve_device`'s error."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    src = io.BytesIO(artefacts("c")[0])
    dst = io.BytesIO()
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(serving.ARTEFACT_META):
                data = json.dumps({"device": "cuda", "family": "c"}).encode()
            zout.writestr(item, data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_scorer(dst.getvalue())


def test_build_model_registry():
    """`build_model` gives each family config its model class; a config of
    no family raises `KeyError`, as in `cvad_tpu`."""
    for family, cfg in (("c", FamilyCConfig()), ("e", FamilyEConfig()),
                        ("d", FamilyDConfig())):
        assert type(build_model(cfg)) is MODEL_REGISTRY[family]
    with pytest.raises(KeyError, match="no model registered"):
        build_model(object())


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_cli_export_then_load_scorer(device, tmp_path, capsys, monkeypatch):
    """``cli export`` writes the fixture's family-D artefact and prints
    ``{"out", "bytes"}``; `load_scorer` runs it as the eager scorer does;
    ``serve`` takes the artefact at its clip shape; ``--preset``, ``--set``
    and ``--clip-len`` give the model config and the clip."""
    if device == "cuda":
        _card()
    out = tmp_path / "d.pt2"
    assert cli.main(["export", CKPT, "--family", "d", "--out", str(out),
                     "--device", device]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"out": str(out), "bytes": out.stat().st_size}
    fn = serving.load_scorer(out.read_bytes())
    clips = np.random.default_rng(4).uniform(0, 1, (3, 8, 64, 64, 3)).astype(
        np.float32)
    ref = make_score_fn("d", load_torch_state_dict(CKPT), device=device)(
        clips)
    for got, want in zip(fn(clips), ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    seen = {}
    serve_forever = http_service.ScoringHTTPServer.serve_forever

    def serve_briefly(self):
        seen["clip_shape"] = self.service.clip_shape
        threading.Timer(0.2, self._httpd.shutdown).start()
        serve_forever(self)

    monkeypatch.setattr(http_service.ScoringHTTPServer, "serve_forever",
                        serve_briefly)
    assert cli.main(["serve", str(out), "--port", "0", "--buckets",
                     "1,2", "--probe-timeout", "120", "--device",
                     device]) == 0
    assert seen["clip_shape"] == (8, 64, 64, 3)

    c_pth = tmp_path / "c.pth"
    cfg = FamilyCConfig(conv_channels=(4, 8, 8))
    torch.save({"model_state_dict": build_model(cfg).state_dict()}, c_pth)
    c_out = tmp_path / "c.pt2"
    assert cli.main(["export", str(c_pth), "--family", "c", "--out",
                     str(c_out), "--preset", "mini3d", "--set",
                     "model.conv_channels=4,8,8", "--clip-len", "4",
                     "--device", device]) == 0
    assert serving.load_scorer(c_out.read_bytes()).clip_shape == \
        (4, 64, 64, 1)


def test_serve_refuses_pth_of_a_c_e_and_probes_the_card(artefacts, tmp_path,
                                                        capsys, monkeypatch):
    """``serve`` of a family-A, C or E ``.pth``, of an empty file, or of a
    CPU artefact on CUDA exits 1 with a JSON error (naming ``cli export``,
    and ``--device cpu``) before the device probe; serving on CUDA, a
    device probe that does not answer exits 1 with `cvad_tpu`'s JSON error
    before any model loads."""
    from cvad_tpu_torch.runtime import doctor

    probed = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(doctor, "probe_devices", lambda timeout: (
        probed.append(timeout) or ("timeout", f"{timeout:.0f}s")))
    pth = tmp_path / "c.pth"
    torch.save({"model_state_dict": build_model(FamilyCConfig())
                .state_dict()}, pth)
    art = tmp_path / "c.pt2"
    art.write_bytes(artefacts("c")[0])
    (tmp_path / "empty").write_bytes(b"")
    refused = [([str(pth), "--family", f], "cli export") for f in "ace"]
    refused += [([str(tmp_path / "empty")], "empty file"),
                ([str(art)], "exported for cpu, not cuda: serve it with "
                             "--device cpu")]
    for argv, match in refused:
        assert cli.main(["serve", *argv, "--port", "0"]) == 1
        err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(err) == {"error"} and match in err["error"]
    assert probed == []
    assert cli.main(["serve", CKPT, "--port", "0",
                     "--probe-timeout", "7"]) == 1
    err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert err == {"error": "accelerator unreachable",
                   "device_probe": "timeout", "detail": "7s"}
    assert probed == [7.0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_artefact_matches_eager_scorer_on_card(name):
    """Exported on the card: every output within 1e-5 of the eager scorer
    (TF32 off) at batch 1, 3 and 8, each kernel's launch count through the
    artefact equal to the eager scorer's on the same batch, a second call
    bit-identical; B with attention at T=128, head dim 128 (K6)."""
    _card()
    from cvad_tpu_torch.train.graphs import read_counters

    family, cfg, clip, ops = CASES[name]
    if name == "b_attn":
        cfg, clip = FamilyBConfig(**CARD_B_ATTN), (128, 64, 64, 1)
        ops = ops | {"flash_attention_forward"}
    state = _state(name, cfg)
    blob = EXPORTERS[family](state, clip_shape=clip, cfg=cfg, device="cuda")
    assert serving.artefact_meta(blob)["device"] == "cuda"
    fn = serving.load_scorer(blob)
    assert _kernel_ops(fn) == ops
    _check_against_eager(family, fn, state, cfg, clip, "cuda", 1e-5)
    eager = make_score_fn(family, state, cfg=cfg, device="cuda")
    x = np.random.default_rng(7).uniform(0, 1, (8,) + clip).astype(np.float32)
    counts = []
    for call in (fn, eager):
        before = read_counters()
        call(x)
        torch.cuda.synchronize()
        counts.append({k: v - before[k] for k, v in read_counters().items()})
    assert counts[0] == counts[1]
    for a, b in zip(_outputs(fn(x)), _outputs(fn(x))):
        assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OPS)
def test_opcheck_on_card(name):
    """`torch.library.opcheck` on CUDA tensors: the kernels against the
    fakes, schema and AOT dispatch."""
    _card()
    op = getattr(torch.ops.cvad_torch, name).default
    torch.library.opcheck(op, _op_inputs(name, "cuda"))


@pytest.mark.cuda
def test_quickstart_on_card(tmp_path):
    """``python -m cvad_tpu_torch.quickstart --serve`` on the card: train,
    evaluate, export, load with no model code, score, serve."""
    _card()
    from cvad_tpu_torch import quickstart

    assert quickstart.main(["--epochs", "1", "--clips", "32", "--out",
                            str(tmp_path), "--serve"]) == 0
