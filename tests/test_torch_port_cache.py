"""The device clip cache (`data/device_cache.py`) and the pinned prefetcher
(`data/batcher.py::DevicePrefetcher`) on the CPU: the cache's batch
composition (order, valid masks, chunks, skip) equals `cvad_tpu`'s and the
host feed's; a cached fit and a cached evaluate equal the uncached ones
bit for bit; the budget gate, the reserved bytes, 'on' refusing an
ineligible train loader and 'auto' passing one by, as
tests/test_device_cache.py holds `cvad_tpu`'s cache.  The `cuda` tests
hold the same on the card.
"""

import numpy as np
import pytest
import torch

from cvad_tpu_torch.config import preset
from cvad_tpu_torch.data.batcher import BatchLoader, DevicePrefetcher
from cvad_tpu_torch.data.datasets import SyntheticClipDataset
from cvad_tpu_torch.data.device_cache import (DeviceClipCache,
                                              cache_eligible,
                                              device_bytes_limit)
from cvad_tpu_torch.runtime.mesh import pad_with_valid
from cvad_tpu_torch.train.engine import Trainer

N, BATCH = 19, 8  # two full batches and a remainder of 3


def _cfg(tmp_path, mode, epochs=2, steps_per_call=1):
    cfg = preset("family_d")
    return cfg.replace(
        data=cfg.data.replace(batch_size=BATCH, frame_size=(16, 16),
                              transfer_dtype="uint8"),
        train=cfg.train.replace(num_epochs=epochs, eval_every=10**9,
                                save_interval=0, log_every=10**9,
                                out_dir=str(tmp_path / mode),
                                device_cache=mode,
                                steps_per_call=steps_per_call))


def _loader(cfg, n=N, shuffle=True, dtype="uint8", split="Train"):
    return BatchLoader(SyntheticClipDataset(cfg.data, n=n, split=split),
                       cfg.data.batch_size, shuffle=shuffle, seed=3,
                       transfer_dtype=dtype)


def _numpy(batch):
    return {k: v.cpu().numpy() for k, v in batch.items()}


def _jax_side(cfg):
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    from cvad_tpu.config import DataConfig as JaxDataConfig
    from cvad_tpu.data.batcher import BatchLoader as JaxLoader
    from cvad_tpu.data.datasets import SyntheticClipDataset as JaxDataset

    jdata = JaxDataConfig(frame_size=cfg.data.frame_size,
                          batch_size=BATCH, transfer_dtype="uint8")
    return jax, JaxLoader(JaxDataset(jdata, N, split="Train"), BATCH,
                          shuffle=True, seed=3, transfer_dtype="uint8")


def test_epoch_index_batches_match_jax(tmp_path):
    cfg = _cfg(tmp_path, "on")
    _, ref = _jax_side(cfg)
    ours = _loader(cfg)
    for epoch in (1, 2, 5):
        got, want = ours.epoch_index_batches(epoch), \
            ref.epoch_index_batches(epoch)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,skip,nd", [(1, 0, 1), (2, 0, 1), (2, 1, 1),
                                       (1, 0, 2)])
def test_device_batches_match_jax(tmp_path, k, skip, nd):
    """Indices gathered, labels, valid masks and the (K, B) chunks of each
    epoch equal `cvad_tpu`'s `DeviceClipCache` on the same dataset; with
    a data axis of 2 (`cvad_tpu` on 2 devices) the remainder batch of 3
    is edge-padded to 4 with a 0 in its mask, as there."""
    cfg = _cfg(tmp_path, "on")
    jax, ref_loader = _jax_side(cfg)
    from cvad_tpu.data.device_cache import DeviceClipCache as JaxCache
    from cvad_tpu.runtime.mesh import create_mesh

    ref = JaxCache(ref_loader, create_mesh(devices=jax.devices("cpu")[:nd]))
    ours = DeviceClipCache(_loader(cfg), "cpu")
    for epoch in (1, 2):
        got = [_numpy(b) for b in ours.device_batches(epoch, k, nd, skip)]
        want = [jax.device_get(b) for b in ref.device_batches(epoch, k, nd,
                                                               skip=skip)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].shape == b[key].shape, key
                np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_device_batches_equal_host_batches(tmp_path):
    """The cache's batches equal the host loader's collated batches with
    their valid masks, value for value, for a shuffled epoch."""
    cfg = _cfg(tmp_path, "on")
    cache = DeviceClipCache(_loader(cfg), "cpu")
    host = _loader(cfg)
    host.set_epoch(1)
    got = [_numpy(b) for b in cache.device_batches(1, 1)]
    want = [pad_with_valid(b, 1) for b in host]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def _fit(cfg, n=N):
    trainer = Trainer(cfg, device="cpu")
    hist = trainer.fit(_loader(cfg, n))
    return trainer, hist


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_cached_fit_bit_identical(tmp_path, steps_per_call):
    on, hist_on = _fit(_cfg(tmp_path, "on", steps_per_call=steps_per_call))
    off, hist_off = _fit(_cfg(tmp_path, "off",
                              steps_per_call=steps_per_call))
    assert any(c is not None for _, c in on._device_caches.values())
    assert all(c is None for _, c in off._device_caches.values())
    for (k, a), (_, b) in zip(on.state.model.state_dict().items(),
                              off.state.model.state_dict().items()):
        assert torch.equal(a, b), k
    for name in ("mu", "nu", "count"):
        assert torch.equal(getattr(on.state.opt_state, name),
                           getattr(off.state.opt_state, name))
    assert hist_on == hist_off


def test_cached_evaluate_matches_uncached(tmp_path):
    results = {}
    for mode in ("on", "off"):
        trainer = Trainer(_cfg(tmp_path, mode), device="cpu")
        trainer.init_state()
        eval_loader = _loader(trainer.cfg, n=11, shuffle=False, split="Test")
        results[mode] = trainer.evaluate(eval_loader)
        cached = trainer._device_caches.get(id(eval_loader), (0, None))[1]
        assert (cached is not None) == (mode == "on")
    on, off = results["on"], results["off"]
    assert set(on) == set(off)
    for k in on:
        np.testing.assert_array_equal(np.asarray(on[k]), np.asarray(off[k]))


def test_on_mode_eval_falls_back_uncached(tmp_path):
    """'on' demands the cache for train loaders only: an ineligible eval
    loader runs uncached."""
    trainer = Trainer(_cfg(tmp_path, "on"), device="cpu")
    trainer.init_state()
    eval_loader = _loader(trainer.cfg, n=6, shuffle=False, dtype="float32",
                          split="Test")
    metrics = trainer.evaluate(eval_loader)
    assert trainer._device_caches[id(eval_loader)][1] is None
    assert "predictions" in metrics


def test_auto_skips_float32_loader(tmp_path):
    cfg = _cfg(tmp_path, "auto")
    loader = _loader(cfg, n=8, dtype="float32")
    assert not cache_eligible(loader, 0.5)
    trainer = Trainer(cfg, device="cpu")
    assert trainer._clip_cache(loader) is None
    assert trainer._clip_cache(_loader(cfg, n=8)) is not None


def test_on_raises_for_ineligible_loader(tmp_path):
    trainer = Trainer(_cfg(tmp_path, "on"), device="cpu")
    with pytest.raises(ValueError, match="ineligible"):
        trainer._clip_cache(_loader(trainer.cfg, n=8, dtype="float32"))
    with pytest.raises(ValueError, match="epoch_index_batches"):
        trainer._clip_cache([{"clips": np.zeros((1, 8, 16, 16, 3))}])


def test_budget_gate(tmp_path):
    """A split larger than the memory fraction stays uncached."""
    loader = _loader(_cfg(tmp_path, "auto"), n=8)
    assert cache_eligible(loader, 0.5)
    assert not cache_eligible(loader, 1e-12)
    assert device_bytes_limit() == device_bytes_limit("cpu") == 4 << 30


def test_budget_counts_reserved_bytes(tmp_path):
    """The budget covers the caches already held: a second split that fits
    alone but not beside the first stays uncached."""
    loader = _loader(_cfg(tmp_path, "auto"), n=8)
    clip_bytes = 8 * int(np.prod(loader.dataset.get_uint8(0)[0].shape))
    frac = 1.5 * clip_bytes / device_bytes_limit()
    assert cache_eligible(loader, frac)
    assert not cache_eligible(loader, frac, reserved_bytes=clip_bytes)


def test_prefetcher_yields_put_batch(tmp_path):
    """`DevicePrefetcher` over the host batches yields what
    `Trainer.put_batch` gives for each, and as many; over
    `_chunk_batches`' chunks, what `Trainer.put_chunk` gives."""
    trainer = Trainer(_cfg(tmp_path, "off"), device="cpu")
    loader = _loader(trainer.cfg)
    loader.set_epoch(1)
    host = list(loader)
    got = list(DevicePrefetcher((pad_with_valid(b, 1) for b in host),
                                "cpu"))
    assert len(got) == len(host)
    for a, b in zip(got, host):
        want = trainer.put_batch(b)
        assert a.keys() == want.keys() == {"clips", "labels", "valid"}
        for k in a:
            assert a[k].dtype == want[k].dtype and torch.equal(a[k], want[k])
    from cvad_tpu_torch.train.engine import _chunk_batches

    chunk = next(iter(DevicePrefetcher(_chunk_batches(iter(host), 2),
                                       "cpu")))
    want = trainer.put_chunk(host[:2])
    assert chunk["clips"].shape[:2] == (2, BATCH)
    assert chunk.keys() == want.keys()
    assert all(torch.equal(chunk[k], want[k]) for k in want)


@pytest.mark.cuda
def test_cache_and_prefetcher_on_card(tmp_path):
    """On the card: the cache's chunks equal the host batches, and the
    prefetcher's pinned copies equal `put_batch`'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _cfg(tmp_path, "on")
    cache = DeviceClipCache(_loader(cfg), "cuda")
    host = _loader(cfg)
    host.set_epoch(1)
    want = [pad_with_valid(b, 1) for b in host]
    got = [_numpy(b) for b in cache.device_batches(1, 2)]
    assert [g["clips"].ndim for g in got] == [6, 5]
    for key in got[0]:
        np.testing.assert_array_equal(
            got[0][key], np.stack([w[key] for w in want[:2]]))
        np.testing.assert_array_equal(got[1][key], want[2][key])
    trainer = Trainer(cfg, device="cuda")
    fed = list(DevicePrefetcher(want, "cuda"))
    torch.cuda.synchronize()
    for a, b in zip(fed, want):
        direct = trainer.put_batch(b)
        assert all(a[k].is_cuda and torch.equal(a[k], direct[k])
                   for k in direct)
