"""K train steps per call (`train.steps_per_call`) on the CPU: a K-step
fit equals the single-step fit bit for bit for families D, B, C and A;
remainders and shape changes run singly; a 'mid' checkpoint at a chunk
boundary resumes bit-identically; `_chunk_batches` equals `cvad_tpu`'s;
a cached K-step fit of family D against `cvad_tpu`'s `Trainer`; and
``train --profile-dir`` writes a trace.  On the CPU the K steps run as a
plain loop (`train/graphs.py::MultiStep`); the card's CUDA graph is held
to eager steps by the `cuda` tests here and by ``chip_smoke.py`` (phase
``steps_per_call``).
"""

import json

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import FamilyBConfig, preset
from cvad_tpu_torch.data.batcher import BatchLoader
from cvad_tpu_torch.data.datasets import SyntheticClipDataset
from cvad_tpu_torch.train import engine
from cvad_tpu_torch.train.engine import Trainer

B = 2
NARROW_B = dict(conv_channels=(8, 16, 32, 32), latent_dim=16, lstm_hidden=16,
                memory_size=32)


def _cfg(family: str, out, epochs: int = 1, **train):
    """A tiny config of `family` with uint8 transfer and batches of B."""
    if family == "d":
        cfg = preset("family_d")
        data = cfg.data.replace(frame_size=(16, 16))
    elif family == "b":
        cfg = preset("memory_ae")
        cfg = cfg.replace(model=FamilyBConfig(**NARROW_B))
        data = cfg.data  # the encoder's latent takes 64x64 frames
    elif family == "c":
        cfg = preset("mini3d")
        data = cfg.data.replace(frame_size=(16, 16))
    else:
        cfg = preset("causal_pipeline")
        data = cfg.data.replace(frame_size=(32, 48), clip_len=4)
    return cfg.replace(
        data=data.replace(batch_size=B, transfer_dtype="uint8"),
        train=cfg.train.replace(num_epochs=epochs, eval_every=10**9,
                                save_interval=0, log_every=10**9,
                                out_dir=str(out), **train))


def _loader(cfg, n: int) -> BatchLoader:
    return BatchLoader(SyntheticClipDataset(cfg.data, n=n, split="Train"),
                       cfg.data.batch_size, shuffle=True, seed=3,
                       transfer_dtype="uint8")


def _assert_same_run(a: Trainer, b: Trainer):
    for (k, va), (_, vb) in zip(a.state.model.state_dict().items(),
                                b.state.model.state_dict().items()):
        assert torch.equal(va, vb), k
    for name in ("mu", "nu", "count", "lr"):
        assert torch.equal(getattr(a.state.opt_state, name),
                           getattr(b.state.opt_state, name)), name
    assert a.state.step == b.state.step
    assert a.history.as_dict() == b.history.as_dict()


def _spy(trainer: Trainer) -> list:
    """The shapes of the chunks `trainer`'s K-step call receives."""
    seen, call = [], trainer._multi

    def spy(state, chunk, total):
        seen.append(tuple(chunk["clips"].shape[:2]))
        return call(state, chunk, total)

    trainer._multi = spy
    return seen


@pytest.mark.parametrize("family", ["d", "b", "c", "a"])
def test_k_step_fit_bit_identical(tmp_path, family):
    """7 clips in batches of 2: a chunk of 3 steps, then the 4th batch and
    the remainder batch (1 clip) singly; parameters, buffers (BatchNorm
    statistics, family B's bank), Adam, step and history equal the
    single-step fit's."""
    single = Trainer(_cfg(family, tmp_path / "k1"), device="cpu")
    single.fit(_loader(single.cfg, 7))
    multi = Trainer(_cfg(family, tmp_path / "k3", steps_per_call=3),
                    device="cpu")
    multi.init_state()
    seen = _spy(multi)
    multi.fit(_loader(multi.cfg, 7))
    assert seen == [(3, B)]
    assert multi.state.step == single.state.step == 4
    _assert_same_run(single, multi)


def _batches(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [{"clips": rng.integers(0, 256, (n, 2, 4, 4, 1), dtype=np.uint8),
             "labels": rng.uniform(size=n).astype(np.float32)}
            for n in sizes]


SIZES = (2, 2, 3, 2, 2, 2, 1)


def test_chunk_batches_flush_singly():
    """A shape change flushes the pending batches singly, K equal shapes
    stack into a chunk, the remainder passes singly; every batch carries
    its all-ones valid mask."""
    out = list(engine._chunk_batches(iter(_batches(SIZES)), 3))
    assert [o["clips"].ndim for o in out] == [5, 5, 5, 6, 5]
    assert [o["clips"].shape[0] for o in out] == [2, 2, 3, 3, 1]
    assert out[3]["valid"].shape == (3, 2)
    src = _batches(SIZES)
    np.testing.assert_array_equal(out[3]["clips"],
                                  np.stack([b["clips"] for b in src[3:6]]))
    for o in out:
        assert set(o) == {"clips", "labels", "valid"}
        assert o["valid"].dtype == np.float32 and (o["valid"] == 1).all()


def test_chunk_batches_match_jax():
    pytest.importorskip("flax")
    from cvad_tpu.train.engine import _chunk_batches as jax_chunks

    ours = list(engine._chunk_batches(iter(_batches(SIZES)), 3))
    ref = list(jax_chunks(iter(_batches(SIZES)), 3, 1))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


class _Interrupted(Exception):
    pass


class _Dying(Trainer):
    """Dies right after its 'mid' checkpoint in the last epoch."""

    def _save_mid(self, epoch, count, total_vec):
        super()._save_mid(epoch, count, total_vec)
        if epoch == self.cfg.train.num_epochs:
            raise _Interrupted


@pytest.mark.parametrize("cache", ["off", "on"])
def test_mid_resume_at_chunk_boundary(tmp_path, cache):
    """K=3, save_every_steps=3, 5 batches an epoch (a chunk, then 2
    singles): a run that dies after epoch 2's 'mid' checkpoint at the
    chunk boundary resumes there and ends bit-identical to the
    uninterrupted single-step run."""
    full = Trainer(_cfg("d", tmp_path / "full", 2), device="cpu")
    full.fit(_loader(full.cfg, 10))
    cfg = _cfg("d", tmp_path / "mid", 2, steps_per_call=3,
               save_every_steps=3, device_cache=cache)
    with pytest.raises(_Interrupted):
        _Dying(cfg, device="cpu").fit(_loader(cfg, 10))
    resumed = Trainer(cfg, device="cpu")
    assert resumed.restore() is not None
    assert (int(resumed._mid_resume["epoch"]),
            int(resumed._mid_resume["count"])) == (2, 3)
    resumed.fit(_loader(cfg, 10))
    _assert_same_run(full, resumed)


def test_cached_k_step_fit_matches_jax(tmp_path):
    """Family D at 16x16, 24 clips in batches of 4 (2 chunks of 3), dropout
    0 and pseudo-anomaly rate 0 (the frameworks draw different bits), the
    device cache on and 3 steps a call on both sides, from `cvad_tpu`'s
    initial parameters: each epoch's loss within rtol 1e-5 and the
    parameters within 2e-5 (tests/test_torch_port_train_step.py's
    tolerances for 20 steps)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from cvad_tpu.config import preset as jax_preset
    from cvad_tpu.data.batcher import BatchLoader as JaxLoader
    from cvad_tpu.data.datasets import SyntheticClipDataset as JaxDataset
    from cvad_tpu.runtime.mesh import create_mesh
    from cvad_tpu.train.engine import Trainer as JaxTrainer
    from cvad_tpu_torch.runtime.checkpoint import (from_jax_family_d,
                                                   from_jax_opt_state)

    def configure(cfg, out):
        return cfg.replace(
            model=cfg.model.replace(dropout=0.0),
            loss=cfg.loss.replace(pseudo_anomaly_rate=0.0),
            data=cfg.data.replace(frame_size=(16, 16), batch_size=4,
                                  transfer_dtype="uint8"),
            train=cfg.train.replace(num_epochs=2, eval_every=10**9,
                                    save_interval=0, log_every=10**9,
                                    steps_per_call=3, device_cache="on",
                                    out_dir=str(out)))

    jcfg = configure(jax_preset("family_d"), tmp_path / "jax")
    cfg = configure(preset("family_d"), tmp_path / "port")
    jloader = JaxLoader(JaxDataset(jcfg.data, 24, split="Train"), 4,
                        shuffle=True, seed=3, transfer_dtype="uint8")
    jt = JaxTrainer(jcfg, mesh=create_mesh(devices=jax.devices("cpu")[:1]))
    jt.init_state(jloader.sample_batch())
    ours = Trainer(cfg, device="cpu")
    ours.init_state()
    ours.state.model.load_state_dict(from_jax_family_d(
        {"params": jax.device_get(jt.state.params)}), strict=True)
    init = from_jax_opt_state(jax.device_get(jt.state.opt_state),
                              ours.state.model)
    for name in ("mu", "nu", "count", "lr"):
        getattr(ours.state.opt_state, name).copy_(getattr(init, name))
    seen = _spy(ours)
    with jax.default_matmul_precision("highest"):
        jhist = jt.fit(jloader)
    hist = ours.fit(_loader(cfg, 24))
    assert seen == [(3, 4)] * 4
    np.testing.assert_allclose(hist["train_losses"], jhist["train_losses"],
                               rtol=1e-5)
    jp = from_jax_family_d({"params": jax.device_get(jt.state.params)})
    for k, v in ours.state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jp[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
    assert ours.state.step == 12


def test_cli_profile_dir_writes_trace(tmp_path):
    """``train --profile-dir`` profiles one unrecorded epoch 0 and writes
    a Chrome trace; the run then trains its epoch as usual, here with 2
    steps a call and the device cache on."""
    from cvad_tpu_torch.cli import main
    from cvad_tpu_torch.runtime.metrics import TRACE_NAME

    prof = tmp_path / "prof"
    assert main(["train", "--epochs", "1", "--n-synthetic", "8",
                 "--device", "cpu", "--out", str(tmp_path / "run"),
                 "--profile-dir", str(prof),
                 "--set", "data.batch_size=4",
                 "--set", "data.frame_size=16,16",
                 "--set", "data.transfer_dtype=uint8",
                 "--set", "train.steps_per_call=2",
                 "--set", "train.device_cache=on"]) == 0
    trace = json.loads((prof / TRACE_NAME).read_text())
    assert any("train_step" in str(e.get("name", "")) or
               e.get("ph") == "X" for e in trace["traceEvents"])
    hist = json.loads((tmp_path / "run" / "improved_training_history.json")
                      .read_text())
    assert hist["epochs"] == [1]


@pytest.mark.cuda
def test_graph_replays_equal_eager_steps_on_card():
    """Family D at 16x16, B=4: 6 eager steps against 2 replays of a
    captured graph of 3 steps, from the same state: every state tensor,
    step and the summed metrics bit-identical, and each kernel's launch
    count through the replays equal to the eager steps'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cvad_tpu_torch.train.graphs import StepGraph, read_counters
    from cvad_tpu_torch.train.tasks import build_task

    cfg = _cfg("d", "unused")
    task = build_task(cfg)
    rng = np.random.default_rng(0)
    batches = [{"clips": torch.from_numpy(rng.integers(
        0, 256, (4, 8, 16, 16, 3), dtype=np.uint8)).cuda(),
        "labels": torch.zeros(4, device="cuda"),
        "valid": torch.ones(4, device="cuda")} for _ in range(6)]
    eager = task.init_state(0, "cuda")
    before, total = read_counters(), None
    for b in batches:
        eager, m = task.train_step(eager, b, 1)
        vec = torch.stack([m[k].float() for k in sorted(m)])
        total = vec if total is None else total + vec
    eager_n = {k: v - before[k] for k, v in read_counters().items()}
    graphed = task.init_state(0, "cuda")
    chunks = [{k: torch.stack([b[k] for b in batches[i:i + 3]])
               for k in batches[0]} for i in (0, 3)]
    graph = StepGraph(task, graphed, 1, chunks[0])
    before, g_total = read_counters(), None
    for ch in chunks:
        _, g_total = graph.replay(graphed, ch, g_total)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in read_counters().items()} == eager_n
    assert torch.equal(total, g_total) and eager.step == graphed.step == 6
    sa, sb = eager.model.state_dict(), graphed.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for name in ("mu", "nu", "count", "lr"):
        assert torch.equal(getattr(eager.opt_state, name),
                           getattr(graphed.opt_state, name))
