"""The port's data package against `cvad_tpu`'s on the CPU: the synthetic
tree writer (byte-identical trees), folder scanning and clip windows, the
label policies, the ground-truth readers, resize and frame decode on every
backend present, `ClipDataset` (`__getitem__`, `get_uint8`, both caches)
for UCSD Ped2 and Avenue, `build_dataset`, `BatchLoader`'s `warm_frames`
hook and `create_avenue_dataloaders`.

Trees are 2 videos a split of 24 frames at 64x64, written under `tmp_path`
by both packages from the same seed.  Nothing here imports JAX: `cvad_tpu`'s
data modules are numpy only.
"""

import filecmp
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from cvad_tpu.config import DataConfig as JaxDataConfig
from cvad_tpu.data import datasets as jds
from cvad_tpu.data import decode as jdecode
from cvad_tpu.data import frames as jframes
from cvad_tpu.data import ground_truth as jgt
from cvad_tpu.data import labels as jlabels
from cvad_tpu.data.batcher import BatchLoader as JaxBatchLoader
from cvad_tpu.data.synthetic import \
    write_synthetic_video_tree as jax_write_tree
from cvad_tpu_torch.config import DataConfig
from cvad_tpu_torch.data import datasets, decode, frames, ground_truth, labels
from cvad_tpu_torch.data import native_decoder
from cvad_tpu_torch.data.batcher import BatchLoader
from cvad_tpu_torch.data.synthetic import write_synthetic_video_tree

# TIFF trees are written through PIL (the tests that take them skip
# without it, as `cvad_tpu`'s do)
FORMATS = ["pgm", "ppm", "npy", "tif"]
TREE = dict(videos_per_split=2, frames_per_video=24, hw=(64, 64))


def _trees(root: Path, **kw) -> tuple:
    """The same tree written by `cvad_tpu` (``jax/``) and the port
    (``port/``)."""
    args = {**TREE, **kw}
    a = jax_write_tree(str(root / "jax"), **args)
    b = write_synthetic_video_tree(str(root / "port"), **args)
    return a, b


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A gray PGM tree with `_gt` mask folders, written by the port."""
    root = tmp_path_factory.mktemp("tree")
    return write_synthetic_video_tree(str(root / "t"), write_gt=True, **TREE)


def _same_files(a: str, b: str) -> None:
    fa = sorted(p.relative_to(a) for p in Path(a).rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in Path(b).rglob("*") if p.is_file())
    assert fa == fb and fa
    _, mismatch, errors = filecmp.cmpfiles(a, b, [str(f) for f in fa],
                                           shallow=False)
    assert mismatch == [] and errors == []


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("channels", [1, 3])
def test_trees_byte_identical(tmp_path, fmt, channels):
    if fmt == "tif":
        pytest.importorskip("PIL")
    a, b = _trees(tmp_path, fmt=fmt, channels=channels, write_gt=True,
                  seed=3)
    _same_files(a, b)


def test_tree_npy_masks_byte_identical(tmp_path):
    a, b = _trees(tmp_path, write_gt=True, gt_fmt="npy", seed=4)
    _same_files(a, b)


@pytest.mark.parametrize("clip_len,stride,cap", [(8, 4, 0), (8, 2, 3),
                                                 (16, 8, 0), (30, 4, 0)])
def test_scan_and_windows(tree, clip_len, stride, cap):
    for split in ("Train", "Test"):
        root = str(Path(tree) / split)
        want = jframes.scan_video_folders(root)
        got = frames.scan_video_folders(root)
        assert got == want and len(got) == 2  # the _gt folders skipped
        cw = jframes.clip_windows(want, clip_len, stride, cap)
        cg = frames.clip_windows(got, clip_len, stride, cap)
        assert [(c.video, c.frames, c.start, c.video_index) for c in cg] == \
            [(c.video, c.frames, c.start, c.video_index) for c in cw]
        if cap:
            assert len(cg) == cap * 2


def test_scan_flat_layout_and_missing_root(tree, tmp_path):
    flat = str(Path(tree) / "Test" / "Test001")
    assert frames.scan_video_folders(flat) == \
        jframes.scan_video_folders(flat)
    assert len(frames.scan_video_folders(flat)) == 1
    with pytest.raises(FileNotFoundError):
        frames.scan_video_folders(str(tmp_path / "absent"))


def _gt(tree: str) -> dict:
    names = [n for n, _ in frames.scan_video_folders(str(Path(tree) /
                                                         "Test"))]
    return ground_truth.load_gt_frame_labels(tree, "Test", names)


@pytest.mark.parametrize("policy", sorted(labels.POLICIES))
@pytest.mark.parametrize("split", ["Train", "Test"])
def test_label_policies(tree, policy, split):
    videos = frames.scan_video_folders(str(Path(tree) / split))
    lengths = [len(f) for _, f in videos]
    fl = _gt(tree) if policy == "ground_truth" and split == "Test" else None
    for clip_len, stride in ((8, 4), (8, 2), (4, 20)):
        clips = frames.clip_windows(videos, clip_len, stride)
        got = labels.assign_labels(policy, clips, split, lengths,
                                   frame_labels=fl)
        want = jlabels.assign_labels(
            policy, jframes.clip_windows(videos, clip_len, stride), split,
            lengths, frame_labels=fl)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
    with pytest.raises(KeyError):
        labels.assign_labels("nope", clips, split, lengths)


def test_mixed_simple_balance_flip():
    """One video of normal-only clips takes mixed_simple's forced flip,
    drawn from default_rng(0) in both packages."""
    clips = [frames.ClipSpec("v1", ("a",) * 8, s, 1) for s in range(40)]
    got = labels.mixed_simple(clips, "Train", [50])
    assert got == jlabels.mixed_simple(clips, "Train", [50])
    assert 0 < sum(got) < len(got)


def _write_mat(tmp_path: Path, n_videos: int = 2, n_frames: int = 24):
    from scipy.io import savemat

    d = tmp_path / "testing_label_mask"
    d.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for v in range(n_videos):
        cells = np.empty((1, n_frames), dtype=object)
        for t in range(n_frames):
            m = np.zeros((8, 8), np.uint8)
            if rng.uniform() < 0.4:
                m[rng.integers(8), rng.integers(8)] = 1
            cells[0, t] = m
        savemat(str(d / f"{v + 1}_label.mat"), {"volLabel": cells})


@pytest.mark.parametrize("kind", ["gt_masks", "npy_sidecar",
                                  "npy_in_folder", "avenue_mat"])
def test_gt_frame_labels(tmp_path, kind):
    root = Path(write_synthetic_video_tree(str(tmp_path / "t"),
                                           write_gt=kind == "gt_masks",
                                           **TREE))
    names = [n for n, _ in frames.scan_video_folders(str(root / "Test"))]
    rng = np.random.default_rng(6)
    if kind == "npy_sidecar":
        for n in names:
            np.save(root / "Test" / f"{n}_gt.npy", rng.integers(0, 2, 24))
    elif kind == "npy_in_folder":
        for n in names:
            (root / "Test" / f"{n}_gt").mkdir()
            np.save(root / "Test" / f"{n}_gt" / "labels.npy",
                    rng.integers(0, 2, 24))
    elif kind == "avenue_mat":
        _write_mat(root)
    got = ground_truth.load_gt_frame_labels(str(root), "Test", names)
    want = jgt.load_gt_frame_labels(str(root), "Test", names)
    assert sorted(got) == sorted(want) == sorted(names)
    for n in names:
        np.testing.assert_array_equal(got[n], want[n])
        assert got[n].dtype == np.float32 and got[n].shape == (24,)
    clips = frames.clip_windows(frames.scan_video_folders(
        str(root / "Test")), 8, 4)
    np.testing.assert_array_equal(
        ground_truth.clip_labels_from_frames(clips, got),
        jgt.clip_labels_from_frames(clips, want))


@pytest.mark.parametrize("hw,out", [((64, 64), (64, 64)), ((240, 360),
                                                          (64, 64)),
                                    ((17, 9), (33, 40)), ((5, 7), (1, 1))])
@pytest.mark.parametrize("c", [1, 3])
def test_resize_bilinear_bit_identical(hw, out, c):
    img = np.random.default_rng(7).uniform(0, 255, hw + (c,)).astype(
        np.float32)
    got = decode.resize_bilinear(img, out)
    np.testing.assert_array_equal(got, jdecode.resize_bilinear(img, out))
    assert got.shape == out + (c,)


def _backends(fmt: str) -> list:
    """The decode backends this host has for `fmt`."""
    names = ["auto"]
    if fmt == "npy":
        return names + ["npy"]
    if native_decoder.load_library() is not None:
        names.append("native")
    names += [b for b, mod in (("cv2", "cv2"), ("pil", "PIL"))
              if importlib.util.find_spec(mod) is not None]
    return names


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_frame_bit_identical(tmp_path, fmt):
    if fmt == "tif":
        pytest.importorskip("PIL")
    root = write_synthetic_video_tree(str(tmp_path / "t"), fmt=fmt,
                                      channels=3 if fmt == "ppm" else 1,
                                      **TREE)
    paths = frames.scan_video_folders(str(Path(root) / "Test"))[0][1][:3]
    for backend in _backends(fmt):
        for size in ((64, 64), (48, 80)):
            for gray in (True, False):
                for p in paths:
                    got = decode.decode_frame(p, size, gray, backend)
                    want = jdecode.decode_frame(p, size, gray, backend)
                    np.testing.assert_array_equal(got, want)
                    assert got.shape == size + (1 if gray else 3,)
                    assert got.max() > 0
    # a file no backend reads: the reference's zero frame
    bad = tmp_path / "bad.pgm"
    bad.write_bytes(b"not an image")
    z = decode.decode_frame(str(bad), (8, 8), False)
    np.testing.assert_array_equal(z, np.zeros((8, 8, 3), np.float32))


def test_native_decoder_is_the_ports_build():
    """The port builds native/decoder.cpp into cvad_tpu_torch/build/ and
    never loads native/libcvaddecode.so."""
    lib = native_decoder.load_library()
    if lib is None:
        pytest.skip("no C++ compiler on this host")
    path = Path(lib._name)
    assert path == native_decoder.library_path()
    assert path.parent.name == "build" and \
        path.parent.parent.name == "cvad_tpu_torch"
    assert {".pgm", ".ppm", ".bmp", ".tif", ".tiff"} <= set(
        native_decoder.supported_suffixes())


def test_native_decoder_keeps_the_build_error(tmp_path, monkeypatch):
    """A build that fails gives None, as in `cvad_tpu`, and keeps the
    compiler's stderr in `last_error`."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'decoder.cpp:1: error: broken' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_decoder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_decoder, "_loaded", [])
    monkeypatch.setattr(native_decoder, "last_error", "")
    assert native_decoder.load_library() is None
    assert "decoder.cpp:1: error: broken" in native_decoder.last_error
    assert not list((tmp_path / "build").glob("*.so"))


def _cfgs(**kw) -> tuple:
    return JaxDataConfig(**kw), DataConfig(**kw)


@pytest.mark.parametrize("name", ["ucsd_ped2", "ucsd_ped2_simple",
                                  "avenue"])
@pytest.mark.parametrize("cache", [True, False])
def test_clip_datasets_bit_identical(tree, name, cache):
    jcfg, cfg = _cfgs(dataset=name, root=tree, channels=3, stride=2,
                      cache_decoded=cache, label_policy="ground_truth",
                      normalize_clamp=(0.001, 0.999))
    for split in ("Train", "Test"):
        want = jds.build_dataset(jcfg, split)
        got = datasets.build_dataset(cfg, split)
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want) == 18
        np.testing.assert_array_equal(got.labels, want.labels)
        if split == "Test":
            assert sorted(got.frame_labels) == sorted(want.frame_labels)
        order = list(range(len(got)))[::-1]  # cold caches in another order
        for i in order:
            a, la = got[i]
            b, lb = want[i]
            np.testing.assert_array_equal(a, b)
            assert la == lb and a.dtype == np.float32
            np.testing.assert_array_equal(got.get_uint8(i)[0],
                                          want.get_uint8(i)[0])
        got.warm_frames(order)  # a no-op once every clip is cached
        assert got[0][0].max() > 0


def test_build_dataset_synthetic_and_unknown():
    cfg = DataConfig(frame_size=(16, 16))
    ds = datasets.build_dataset(cfg, "Train", 4)
    want = jds.build_dataset(JaxDataConfig(frame_size=(16, 16)), "Train", 4)
    np.testing.assert_array_equal(ds.data, want.data)
    with pytest.raises(KeyError):
        datasets.build_dataset(cfg.replace(dataset="nope"))
    with pytest.raises(FileNotFoundError):
        datasets.build_dataset(cfg.replace(dataset="avenue", root="/absent"))


class _Spy(datasets.ClipDataset):
    def __init__(self, ds):
        super().__init__(ds.clips, ds.labels, ds.cfg)
        self.warmed = []

    def warm_frames(self, indices):
        self.warmed.append(list(indices))
        super().warm_frames(indices)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_batch_loader_warms_frames(tree, dtype):
    jcfg, cfg = _cfgs(dataset="ucsd_ped2", root=tree, stride=2)
    ds = _Spy(datasets.build_dataset(cfg, "Test"))
    kw = dict(batch_size=5, shuffle=True, seed=3, transfer_dtype=dtype)
    got = list(BatchLoader(ds, **kw))
    want = list(JaxBatchLoader(jds.build_dataset(jcfg, "Test"), **kw))
    assert len(ds.warmed) == len(got) == len(want) == 4
    assert sorted(i for w in ds.warmed for i in w) == list(range(18))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["clips"], w["clips"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["clips"].dtype == np.dtype(dtype)


def test_create_avenue_dataloaders(tree):
    got = datasets.create_avenue_dataloaders(tree, batch_size=4,
                                             num_workers=2)
    want = jds.create_avenue_dataloaders(tree, batch_size=4, num_workers=2)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        assert g.batch_size == 4  # attributes pass through
        for (gv, gl), (wv, wl) in zip(g, w):
            assert gv.shape[1:] == (3, 8, 64, 64)
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gl, wl)
