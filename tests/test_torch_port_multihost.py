"""The port's mesh and multi-process input helpers against `cvad_tpu`'s, case
for case, with explicit process indices and counts (no process group):
`host_local_slice`, `HostShardDataset` and its index protocols,
`per_host_batch_size`, `make_host_loader`'s equal step counts on uneven
shards, the batch padding, `shard_batch` against the shards of a JAX mesh,
`temporal_shards_valid` and the invalid-T error; `initialize` without a
configuration, `create_mesh` without a process group, `form_global_batch`
and `resolve_device` under a process group."""

import numpy as np
import pytest
import torch

from cvad_tpu_torch.runtime import multihost
from cvad_tpu_torch.runtime.mesh import (Axis, Mesh, create_mesh,
                                         host_local_slice, pad_to_multiple,
                                         pad_with_valid, shard_batch,
                                         single_mesh)

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # cvad_tpu's package imports
from cvad_tpu.runtime import mesh as jax_mesh  # noqa: E402
from cvad_tpu.runtime import multihost as jax_multihost  # noqa: E402


class _ToyDataset:
    def __init__(self, n):
        self.n = n
        self.tag = "toy"
        self.warmed = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 4, 4, 1), i, np.float32), np.float32(i % 2)

    def get_uint8(self, i):
        return np.full((2, 4, 4, 1), i % 256, np.uint8), np.float32(i % 2)

    def warm_frames(self, indices):
        self.warmed.extend(int(i) for i in indices)


@pytest.mark.parametrize("n,pc", [(100, 1), (103, 4), (64, 8), (7, 3)])
def test_host_local_slice_matches_jax(n, pc):
    for pi in range(pc):
        assert host_local_slice(n, pi, pc) == jax_mesh.host_local_slice(
            n, pi, pc)


def test_host_shard_dataset_matches_jax():
    """The same items per shard, the passthrough, the index protocols
    translated to global indices, and hidden where the inner dataset has
    none."""
    ours_ds, ref_ds = _ToyDataset(103), _ToyDataset(103)
    for pi in range(4):
        ours = multihost.HostShardDataset(ours_ds, pi, 4)
        ref = jax_multihost.HostShardDataset(ref_ds, pi, 4)
        assert len(ours) == len(ref)
        for i in range(len(ours)):
            np.testing.assert_array_equal(ours[i][0], ref[i][0])
            np.testing.assert_array_equal(ours.get_uint8(i)[0],
                                          ref.get_uint8(i)[0])
        with pytest.raises(IndexError):
            ours[len(ours)]
        with pytest.raises(IndexError):
            ours.get_uint8(len(ours))
        ours.warm_frames([0, 3])
        ref.warm_frames([0, 3])
    assert ours_ds.warmed == ref_ds.warmed
    assert multihost.HostShardDataset(ours_ds, 0, 2).tag == "toy"

    class _Plain:
        def __len__(self):
            return 10

    assert not hasattr(multihost.HostShardDataset(_Plain(), 0, 2),
                       "get_uint8")


@pytest.mark.parametrize("gb,pc", [(256, 4), (30, 4), (7, 8), (9, 3)])
def test_per_host_batch_size_matches_jax(gb, pc):
    parts = [multihost.per_host_batch_size(gb, pc, pi) for pi in range(pc)]
    assert parts == [jax_multihost.per_host_batch_size(gb, pc, pi)
                     for pi in range(pc)]
    assert sum(parts) == gb


@pytest.mark.parametrize("n,pc,gb", [(97, 3, 9), (99, 3, 10), (100, 4, 6)])
def test_make_host_loader_uneven_shards_equal_steps(n, pc, gb):
    """tests/test_multihost.py:140's cases: every process yields the fleet
    minimum of steps, the same batches as `cvad_tpu`'s loader (uint8 path
    included), and the loader is marked host-local."""
    ds = _ToyDataset(n)
    counts = []
    for pi in range(pc):
        ours = multihost.make_host_loader(ds, gb, process_index=pi,
                                          process_count=pc, num_threads=1,
                                          transfer_dtype="uint8")
        ref = jax_multihost.make_host_loader(ds, gb, process_index=pi,
                                             process_count=pc,
                                             num_threads=1,
                                             transfer_dtype="uint8")
        got, want = list(ours), list(ref)
        assert len(ours) == len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.host_local and ours.global_batch == gb
        counts.append(len(got))
    assert len(set(counts)) == 1, counts


def test_host_loader_is_not_cached():
    """A host-local shard stays out of the device clip cache (each rank's
    rows are its own)."""
    from cvad_tpu_torch.data.device_cache import cache_eligible

    ds = _ToyDataset(16)
    loader = multihost.make_host_loader(ds, 4, process_index=0,
                                        process_count=2, num_threads=1,
                                        transfer_dtype="uint8")
    assert not cache_eligible(loader, 0.5)
    loader.host_local = False
    assert cache_eligible(loader, 0.5)


@pytest.mark.parametrize("n,multiple", [(13, 8), (16, 8), (5, 2), (1, 4)])
def test_padding_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    batch = {"clips": rng.uniform(size=(n, 2, 3, 3, 1)).astype(np.float32),
             "labels": rng.integers(0, 2, n).astype(np.float32)}
    ours, n_ours = pad_to_multiple(batch, multiple)
    ref, n_ref = jax_mesh.pad_to_multiple(batch, multiple)
    assert n_ours == n_ref == n
    got, want = pad_with_valid(batch, multiple), jax_mesh.pad_with_valid(
        batch, multiple)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))


def test_shard_batch_matches_jax_mesh_shards():
    """Each rank's part of a batch on a (2 data x 2 time) mesh is the
    shard `cvad_tpu` puts on the device at that cell of its (2, 2) CPU
    mesh: rows over data, frames over time for the clips, rows only for
    the labels."""
    rng = np.random.default_rng(0)
    batch = {"clips": rng.uniform(size=(4, 8, 2, 2, 1)).astype(np.float32),
             "labels": np.arange(4, dtype=np.float32)}
    jm = jax_mesh.create_mesh(data_axis=2, temporal_axis=2,
                              devices=jax.devices("cpu")[:4])
    ref = jax_mesh.shard_batch(jm, batch, time_dim=1)
    for i in range(2):
        for j in range(2):
            mesh = Mesh(Axis(2, i), Axis(2, j))
            got = shard_batch(mesh, batch, time_dim=1)
            dev = jm.devices[i, j]
            for k in batch:
                shard = next(s for s in ref[k].addressable_shards
                             if s.device == dev)
                np.testing.assert_array_equal(got[k], np.asarray(shard.data))
    with pytest.raises(ValueError, match="pad"):
        shard_batch(Mesh(Axis(2, 0), Axis(1, 0)),
                    {"x": np.zeros(3)})


@pytest.mark.parametrize("t,n_time", [(16, 2), (32, 4), (16, 3), (8, 4),
                                      (64, 1), (12, 1), (24, 2)])
def test_temporal_shards_valid_matches_jax(t, n_time):
    from cvad_tpu.parallel.temporal import temporal_shards_valid as ref
    from cvad_tpu_torch.parallel.temporal import temporal_shards_valid

    assert temporal_shards_valid(t, n_time) == ref(t, n_time)


def test_invalid_time_split_raises_as_jax():
    """T=8 over 4 time ranks leaves 2 frames a rank: both raise
    `ValueError` before reading a weight or running a collective."""
    from cvad_tpu.parallel.temporal import \
        temporal_sharded_forward as jax_forward
    from cvad_tpu_torch.models import CausalAnomalyDetector
    from cvad_tpu_torch.parallel.temporal import temporal_sharded_forward

    clips = np.ones((2, 8, 16, 16, 3), np.float32)
    jm = jax_mesh.create_mesh(data_axis=2, temporal_axis=4,
                              devices=jax.devices("cpu")[:8])
    with pytest.raises(ValueError):
        jax_forward({"params": {}}, clips, jm)
    mesh = Mesh(Axis(2, 0), Axis(4, 0))
    with pytest.raises(ValueError, match="not shardable"):
        temporal_sharded_forward(CausalAnomalyDetector(), clips, mesh)


def test_initialize_single_process_noop(monkeypatch):
    """Nothing configured: no process group, one process, idempotent;
    a count without a rendezvous raises."""
    for k in ("CVAD_COORDINATOR", "CVAD_NUM_PROCESSES", "CVAD_PROCESS_ID",
              "WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    info = multihost.initialize()
    assert (info.process_index, info.process_count) == (0, 1)
    assert info.is_primary and info.global_devices >= info.local_devices
    assert multihost.initialize() == info
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("CVAD_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize()


def test_mesh_without_a_process_group():
    """The trivial 1 x 1 mesh: no group on either axis (its collectives
    the identity), rank 0 primary; other layouts need ranks."""
    mesh = create_mesh()
    assert mesh.shape == {"data": 1, "time": 1}
    assert mesh.world is None and mesh.data.group is None and mesh.primary
    assert mesh == single_mesh() and mesh.rows(5) == (5, 0)
    with pytest.raises(ValueError):
        create_mesh(data_axis=2)
    with pytest.raises(ValueError):
        create_mesh(temporal_axis=2)
    got = multihost.form_global_batch(mesh, {"clips": np.zeros((3, 2)),
                                             "labels": np.ones(3)}, "cpu")
    assert got["valid"].tolist() == [1.0, 1.0, 1.0]
    assert got["clips"].shape == (3, 2)


def test_resolve_device_takes_local_rank(monkeypatch):
    """Under a process group a CUDA device without an index is
    ``cuda:LOCAL_RANK``; the CPU stays the CPU."""
    from cvad_tpu_torch.runtime.device import resolve_device

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
