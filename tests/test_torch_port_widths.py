"""Widths `cvad_tpu` runs that the port's kernels did not take before: conv1
at widths other than 3 -> 16 (K1's), K6 at head dims that are multiples of
128 above 128, K3 past one 1,024-wide chunk of D, K2 past one 8,192-wide
chunk of N.

On the CPU: conv1's route choice by width, and the grayscale (family D,
``in_channels=1``) and wide-head (family B, attention at latent 256 with
one head) configurations, one train step each against `cvad_tpu`.  On a
card (``cuda``-marked, skipped without one): each configuration's step card
against CPU, and the kernels at the new widths against their plain
versions.  JAX and `cvad_tpu` are imported inside the tests that use them,
so that the card tests run on a machine without them.
"""

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import FamilyBConfig, preset
from cvad_tpu_torch.models import layers
from cvad_tpu_torch.ops.pallas_conv import (kernel_takes, tfold_conv1,
                                            tfold_conv1_reference)
from cvad_tpu_torch.train.tasks import build_task

# family D: (name, model fields, (T, H, W, C) of a clip) -- the CPU tests
# take 16x16 frames, the card tests 64x64
D_WIDTHS = [("gray_t8", dict(in_channels=1), 8, 1),
            ("gray_t64", dict(in_channels=1), 64, 1),
            ("conv32", dict(conv_channels=(32, 32, 64)), 8, 3)]
# family B with attention: the narrow stack of test_torch_port_train_attn.py
# with one 256-wide head (K6 at head dim 256 on a card, at T=128)
WIDE_HEAD = dict(temporal_encoder="attention", latent_dim=256, attn_heads=1)
NARROW_B = dict(conv_channels=(8, 16, 32, 32), memory_size=16, attn_layers=1)
# Adam's first step is ~lr * sign(g): near-zero gradient entries, rounded
# in another order, can move a parameter by up to ~lr (family D's lr 5e-4)
PARAM_ATOL = 2e-5


def _d_cfg(model, t, hw):
    cfg = preset("family_d")
    return cfg.replace(model=cfg.model.replace(dropout=0.0, **model),
                       data=cfg.data.replace(clip_len=t,
                                             frame_size=(hw, hw)))


def _b_cfg(t, **model):
    cfg = preset("memory_ae")
    return cfg.replace(model=FamilyBConfig(**{**WIDE_HEAD, **model}),
                       data=cfg.data.replace(clip_len=t))


def _d_batch(b, t, hw, c, seed=0):
    rng = np.random.default_rng(seed)
    return {"clips": rng.integers(0, 256, (b, t, hw, hw, c), dtype=np.uint8),
            "pseudo_targets": (rng.uniform(size=b) < 0.25).astype(
                np.float32)}


def _b_batch(b, t, seed=0):
    rng = np.random.default_rng(seed)
    return {"clips": rng.integers(0, 256, (b, t, 64, 64, 1), dtype=np.uint8),
            "labels": np.arange(b, dtype=np.float32) % 2}


# -- conv1's route by width (CPU) ---------------------------------------------


@pytest.mark.parametrize("cin,cout", [(3, 16), (1, 16), (3, 32), (1, 32)])
def test_k1_route_is_chosen_by_width(monkeypatch, cin, cout):
    """`kernel_takes` accepts K1's widths only, and `TFoldConv1` calls
    `tfold_conv1` exactly there (F.conv3d elsewhere); every route gives the
    plain folded conv plus the bias."""
    calls = []
    real = layers.tfold_conv1

    def counted(x, w):
        calls.append(w.shape)
        return real(x, w)

    monkeypatch.setattr(layers, "tfold_conv1", counted)
    assert kernel_takes(cin, cout) == ((cin, cout) == (3, 16))
    torch.manual_seed(0)
    layer = layers.TFoldConv1(cin, cout)
    x = torch.rand(2, cin, 8, 16, 16)
    before = tfold_conv1.launches
    y = layer(x)
    assert len(calls) == int(kernel_takes(cin, cout))
    assert tfold_conv1.launches == before  # CPU tensors launch nothing
    ref = tfold_conv1_reference(x, layer.weight.detach()) \
        + layer.bias.detach().view(1, -1, 1, 1, 1)
    torch.testing.assert_close(y.detach(), ref, rtol=0, atol=1e-5)


# -- the configurations against cvad_tpu (CPU) ---------------------------------


def _jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    return jax


def test_grayscale_family_d_step_matches_jax():
    """Family D with in_channels=1 (conv1 on F.conv3d in the port) at T=8,
    16x16, B=4: one step from the same parameters and optimizer state,
    loss and components within rtol 1e-5, parameters within PARAM_ATOL."""
    jax = _jax()
    import jax.numpy as jnp

    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.train.tasks import build_task as jax_build_task
    from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_d,
                                                   from_jax_opt_state)

    b, t, hw = 4, 8, 16
    jcfg = jax_preset("family_d")
    jcfg = jcfg.replace(model=jcfg.model.replace(dropout=0.0, in_channels=1),
                        data=jcfg.data.replace(clip_len=t,
                                               frame_size=(hw, hw)))
    batch = _d_batch(b, t, hw, 1)
    jtask = jax_build_task(jcfg)
    js = jtask.init_state(jax.random.key(0),
                          {"clips": jnp.asarray(batch["clips"])})
    with jax.default_matmul_precision("highest"):
        js1, jm = jax.jit(jtask.train_step)(
            js, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(1))
    task = build_task(_d_cfg(dict(in_channels=1), t, hw))
    state = task.init_state(0, "cpu")
    state.model.load_state_dict(from_jax_family_d({"params": js.params}),
                                strict=True)
    state.opt_state = from_jax_opt_state(js.opt_state, state.model)
    assert state.model.feature_extractor.conv3d_1.weight.shape[1] == 1
    state, m = task.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = from_jax_family_d({"params": js1.params})
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_wide_head_family_b_step_matches_jax():
    """Family B with the attention encoder at latent 256, one head (head
    dim 256; the narrow conv stack, one block), T=8, B=2: one step from
    the same parameters, the loss and normal count within rtol 1e-5 and
    the parameters within 2e-5 (test_torch_port_train_attn.py's, at its lr
    of 1e-5)."""
    jax = _jax()
    import jax.numpy as jnp

    from cvad_tpu.config import FamilyBConfig as JaxFamilyBConfig
    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.train.tasks import build_task as jax_build_task
    from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_b,
                                                   from_jax_opt_state)

    t, lr = 8, 1e-5
    jcfg = jax_preset("memory_ae")
    jcfg = jcfg.replace(model=JaxFamilyBConfig(**WIDE_HEAD, **NARROW_B),
                        data=jcfg.data.replace(clip_len=t),
                        optim=jcfg.optim.replace(lr=lr))
    batch = _b_batch(2, t)
    jtask = jax_build_task(jcfg)
    js = jtask.init_state(jax.random.key(0),
                          {"clips": jnp.asarray(batch["clips"])})
    with jax.default_matmul_precision("highest"):
        js1, jm = jax.jit(jtask.train_step)(
            js, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(1))
    cfg = _b_cfg(t, **NARROW_B)
    task = build_task(cfg.replace(optim=cfg.optim.replace(lr=lr)))
    state = task.init_state(0, "cpu")
    state.model.load_state_dict(from_jax_family_b(
        {"params": js.params, "batch_stats": js.batch_stats}, js.extra),
        strict=True)
    state.opt_state = from_jax_opt_state(js.opt_state, state.model,
                                         convert=from_jax_family_b)
    state, m = task.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    assert float(m["n_normal"]) == float(jm["n_normal"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-7)
    want = from_jax_family_b({"params": js1.params,
                              "batch_stats": js1.batch_stats}, js1.extra)
    got = state.model.state_dict()
    assert got["normal_memory"].shape == (16, 256)
    for k, _ in state.model.named_parameters():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)


# -- on a card -----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=False, deterministic=True,
                   allow_tf32=False)


def _launches():
    from cvad_tpu_torch.ops.flash_attention import flash_attention

    return {"tfold_conv1": tfold_conv1.launches,
            "flash_forward": flash_attention.launches,
            "flash_dq": flash_attention.dq_launches,
            "flash_dkv": flash_attention.dkv_launches}


def _card_vs_cpu_step(cfg, batch):
    """One float32 step from the seed-0 init on the card and on the CPU:
    (card metrics, CPU metrics, card state, CPU state, card launches)."""
    from cvad_tpu_torch.train.state import float_metrics

    task = build_task(cfg)
    out = []
    for dev in ("cuda", "cpu"):
        st = task.init_state(0, dev)
        before = _launches()
        st, m = task.train_step(st, {k: torch.from_numpy(v).to(dev)
                                     for k, v in batch.items()}, 1)
        rose = {k: v - before[k] for k, v in _launches().items()}
        out.append((float_metrics(m), {k: v.cpu() for k, v in
                                       st.model.state_dict().items()}, rose))
    (mg, sg, rose), (mc, sc, _) = out
    return mg, mc, sg, sc, rose


def _assert_parity(mg, mc, sg, sc):
    """chip_smoke.py's attn_parity tolerances: metrics rtol 1e-4, state
    within 5e-5."""
    for k in mg:
        np.testing.assert_allclose(mg[k], mc[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in sg:
        np.testing.assert_allclose(sg[k].double().numpy(),
                                   sc[k].double().numpy(), rtol=0, atol=5e-5,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name,model,t,c", D_WIDTHS)
def test_conv1_widths_on_card(name, model, t, c):
    """Family D at widths K1 does not take, 64x64, B=2: the eval forward
    (scores, adjacency) within 1e-4 and one train step within attn_parity's
    tolerances, card against CPU; conv1 never launches K1."""
    flags = _card()
    cfg = _d_cfg(model, t, 64)
    batch = _d_batch(2, t, 64, c)
    from cvad_tpu_torch.models import CausalAnomalyDetector

    torch.manual_seed(0)
    model_cpu = CausalAnomalyDetector(cfg.model).eval()
    model_gpu = CausalAnomalyDetector(cfg.model).eval()
    model_gpu.load_state_dict(model_cpu.state_dict())
    model_gpu = model_gpu.cuda()
    x = torch.from_numpy(batch["clips"]).float().div(255).permute(
        0, 4, 1, 2, 3).contiguous()
    before = tfold_conv1.launches
    with flags:
        with torch.no_grad():
            sg, ag, _ = model_gpu(x.cuda())
            sc, ac, _ = model_cpu(x)
        mg, mc, stg, stc, rose = _card_vs_cpu_step(cfg, batch)
    torch.testing.assert_close(sg.cpu(), sc, rtol=0, atol=1e-4)
    torch.testing.assert_close(ag.cpu(), ac, rtol=0, atol=1e-4)
    assert tfold_conv1.launches == before and rose["tfold_conv1"] == 0
    _assert_parity(mg, mc, stg, stc)


@pytest.mark.cuda
def test_wide_head_train_step_on_card():
    """Family B with the attention encoder at latent 256, one head, T=128,
    B=2: one step card against CPU within attn_parity's tolerances, K6
    forward, dQ and dK/dV launched once a block (head dim 256, two
    chunks)."""
    flags = _card()
    cfg = _b_cfg(128)
    with flags:
        mg, mc, sg, sc, rose = _card_vs_cpu_step(cfg, _b_batch(2, 128))
    layers_n = cfg.model.attn_layers
    assert (rose["flash_forward"], rose["flash_dq"], rose["flash_dkv"]) == \
        (layers_n,) * 3
    _assert_parity(mg, mc, sg, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d", [(16, 500, 2048), (8, 64, 4096)])
def test_k3_past_one_chunk_on_card(b, m, d):
    """K3 at D = 2 and 4 chunks of 1,024 against the plain version within
    1e-6 at every fill of {0, 1, M/2, M}; a second call bit-identical."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        memory_min_cosine_distance, memory_min_cosine_distance_reference)

    _card()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).cuda()
    mem = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).cuda()
    for fill in sorted({0, 1, m // 2, m}):
        f = torch.tensor(fill, dtype=torch.int32, device="cuda")
        got = memory_min_cosine_distance(q, mem, f)
        again = memory_min_cosine_distance(q, mem, f)
        ref = memory_min_cosine_distance_reference(q, mem, f)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_k2_past_one_chunk_on_card():
    """K2 at (B, N) = (64, 16384), two chunks of 8,192, on tie-free inputs:
    the mean within rtol 1e-5, the pair count exact, the gradient within
    1e-6 of the plain versions; a second call bit-identical."""
    from cvad_tpu_torch.ops.pallas_kernels import (
        pairwise_l1_backward_reference, pairwise_l1_mean,
        pairwise_l1_reference)

    _card()
    rng = np.random.default_rng(0)
    b, n = 64, 16384
    flat = torch.from_numpy(rng.permutation(b * n).reshape(b, n).astype(
        np.float32) / (b * n)).cuda()  # distinct values: no ties
    m = torch.from_numpy((rng.uniform(size=b) >= 0.05).astype(
        np.float32)).cuda()
    f = flat.clone().requires_grad_(True)
    avg, pairs = pairwise_l1_mean(f, m)
    (g,) = torch.autograd.grad(avg, f)
    avg2, _ = pairwise_l1_mean(f, m)
    (g2,) = torch.autograd.grad(avg2, f)
    ref, ref_pairs = pairwise_l1_reference(flat, m)
    ref_g = pairwise_l1_backward_reference(flat, m, ref_pairs,
                                           torch.ones((), device="cuda"))
    assert pairs.item() == ref_pairs.item()
    torch.testing.assert_close(avg, ref, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(g, ref_g, rtol=0, atol=1e-6)
    assert torch.equal(avg, avg2) and torch.equal(g, g2)
