"""Real ground-truth frame-label ingestion (UCSD Ped2 ``*_gt`` masks,
Avenue ``.mat`` volumes, plain ``.npy`` vectors).

An own copy of `cvad_tpu/data/ground_truth.py`.  PGM and ``.npy`` masks
need numpy alone; scipy reads ``.mat`` volumes, and h5py (v7.3 ``.mat``)
and PIL (BMP, PNG, TIFF masks) stay optional imports, as in `cvad_tpu`.

The reference *sees and skips* the UCSD ground truth — its dataset walk
excludes ``Test00N_gt`` folders (``minicausal_vad_complete3.py:141-143``) and
fabricates labels instead (SURVEY.md §2.1).  The north-star metric
(BASELINE.md: frame-level ROC-AUC vs the reference on real data) needs the
real labels, so this module parses every ground-truth format the two target
datasets ship:

- **UCSD Ped2**: each test video ``Test00N`` has a sibling ``Test00N_gt``
  folder of per-frame binary masks (``.bmp`` in the original release); a
  frame is anomalous iff any mask pixel is nonzero.
- **CUHK Avenue**: ``<root>/[ground_truth_demo/]testing_label_mask/N_label.mat``
  MATLAB volumes — key ``volLabel`` is a (1, T) cell array of (H, W) masks.
  Parsed with ``scipy.io.loadmat``; v7.3 (HDF5) variants fall back to an
  h5py read of the object-reference cell layout.
- **``.npy`` vectors**: ``<video>_gt.npy`` next to the video folder or a
  ``labels.npy``/``frame_labels.npy`` inside ``<video>_gt/`` — a (T,)
  0/1 vector.  This is the format our synthetic fixtures can also emit, so
  the whole path is testable without the real datasets.

All loaders return ``{video_name: (n_frames,) float32 0/1}``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

MASK_EXTS = (".bmp", ".png", ".tif", ".tiff", ".pgm", ".jpg", ".jpeg", ".npy")


def _read_mask(path: str) -> np.ndarray:
    """One mask frame -> 2-D array (any nonzero pixel = anomalous)."""
    p = Path(path)
    if p.suffix.lower() == ".npy":
        return np.asarray(np.load(p))
    if p.suffix.lower() in (".pgm", ".ppm"):
        arr = _read_pnm(p)
        if arr is not None:
            return arr
    from PIL import Image

    return np.asarray(Image.open(p))


def _read_pnm(path: Path) -> Optional[np.ndarray]:
    """Minimal binary PGM/PPM reader (keeps fixture tests PIL-free)."""
    data = path.read_bytes()
    m = re.match(rb"P([56])\s+(\d+)\s+(\d+)\s+(\d+)\s", data)
    if not m:
        return None
    w, h = int(m.group(2)), int(m.group(3))
    ch = 3 if m.group(1) == b"6" else 1
    pix = np.frombuffer(data[m.end():m.end() + w * h * ch], np.uint8)
    if pix.size < w * h * ch:
        return None
    return pix.reshape((h, w, ch) if ch == 3 else (h, w))


def mask_folder_labels(gt_dir: str) -> np.ndarray:
    """Per-frame labels from a folder of mask frames (UCSD ``Test00N_gt``
    layout): sorted mask files, frame anomalous iff any pixel nonzero."""
    d = Path(gt_dir)
    # .npy vector shortcut inside the folder
    for name in ("labels.npy", "frame_labels.npy"):
        if (d / name).is_file():
            return (np.load(d / name).reshape(-1) != 0).astype(np.float32)
    files = sorted(f for f in d.iterdir()
                   if f.suffix.lower() in MASK_EXTS and not f.name.startswith("."))
    return np.asarray([float(np.any(_read_mask(str(f)))) for f in files],
                      np.float32)


def _vector_sidecar(video_dir: Path) -> Optional[np.ndarray]:
    """``<video>_gt.npy`` sibling vector, if present."""
    p = video_dir.parent / (video_dir.name + "_gt.npy")
    if p.is_file():
        return (np.load(p).reshape(-1) != 0).astype(np.float32)
    return None


def load_ucsd_gt(split_dir: str) -> Dict[str, np.ndarray]:
    """All ground truth under one split directory (``.../Test``): for every
    video folder ``X``, look for ``X_gt/`` masks or ``X_gt.npy``."""
    out: Dict[str, np.ndarray] = {}
    root = Path(split_dir)
    if not root.is_dir():
        return out
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        if d.name.lower().endswith("_gt"):
            continue
        vec = _vector_sidecar(d)
        if vec is None and (root / (d.name + "_gt")).is_dir():
            vec = mask_folder_labels(str(root / (d.name + "_gt")))
        if vec is not None and vec.size:
            out[d.name] = vec
    return out


def load_avenue_gt(root: str) -> List[np.ndarray]:
    """Avenue ``N_label.mat`` volumes, ordered by video number N.

    Returns a list (index = test-video order) rather than a name map because
    Avenue's frame folders and label files use different naming schemes; the
    caller aligns by sorted order (the dataset's videos are strictly
    numbered 01..21)."""
    rootp = Path(root)
    mat_dir = next((rootp / sub for sub in
                    ("testing_label_mask", "ground_truth_demo/testing_label_mask")
                    if (rootp / sub).is_dir()), None)
    if mat_dir is None:
        return []
    mats = sorted(mat_dir.glob("*_label.mat"),
                  key=lambda p: int(re.match(r"(\d+)", p.name).group(1)))
    return [_mat_frame_labels(str(p)) for p in mats]


def _mat_frame_labels(path: str) -> np.ndarray:
    try:
        from scipy.io import loadmat

        mat = loadmat(path)
    except (NotImplementedError, ValueError) as e:
        # v7.3 .mat files are HDF5 (512-byte MATLAB userblock + HDF5 body);
        # scipy raises NotImplementedError (or ValueError on a bare-HDF5
        # re-distribution without the userblock) — read them via h5py
        labels = _hdf5_frame_labels(path)
        if labels is not None:
            return labels
        raise NotImplementedError(
            f"{path} is a MATLAB v7.3 (HDF5) file and no h5py is available; "
            "re-save it as v7 or provide an .npy frame-label vector instead"
        ) from e
    vol = mat.get("volLabel")
    if vol is not None:  # (1, T) cell of (H, W) masks
        cells = vol.reshape(-1)
        return np.asarray([float(np.any(c)) for c in cells], np.float32)
    # some re-distributions ship a plain per-frame vector under another key
    for k, v in mat.items():
        if not k.startswith("__") and isinstance(v, np.ndarray):
            return (np.asarray(v).reshape(-1) != 0).astype(np.float32)
    raise KeyError(f"no usable label array in {path}")


def _hdf5_frame_labels(path: str) -> Optional[np.ndarray]:
    """MATLAB v7.3 (HDF5) label volume: ``volLabel`` is stored as an array
    of object references, each pointing at one (H, W) mask dataset; a frame
    is anomalous iff any mask pixel is nonzero.  Returns None when h5py is
    unavailable (caller raises the clear v7.3 error)."""
    try:
        import h5py
    except ImportError:
        return None
    with h5py.File(path, "r") as f:
        vol = f.get("volLabel")
        if vol is not None:
            refs = np.asarray(vol).reshape(-1)
            out = []
            for r in refs:
                if isinstance(r, h5py.Reference):
                    out.append(float(np.any(np.asarray(f[r]))))
                else:  # plain numeric volLabel (already a per-frame value)
                    out.append(float(np.any(r)))
            return np.asarray(out, np.float32)
        for k in f.keys():
            if k.startswith("#"):  # MATLAB internal groups (#refs#, #subsystem#)
                continue
            node = f[k]
            if isinstance(node, h5py.Dataset):
                return (np.asarray(node).reshape(-1) != 0).astype(np.float32)
    raise KeyError(f"no usable label array in {path}")


def load_gt_frame_labels(root: str, split: str,
                         video_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Unified loader: ground truth for `video_names` (the split's video
    folders, in scan order) from whichever format exists under `root`.

    Precedence: per-video ``_gt`` folders / ``_gt.npy`` sidecars (UCSD
    layout, searched in the split dir), then Avenue ``.mat`` volumes aligned
    by sorted order.  Videos with no ground truth are absent from the dict
    (the label policy treats them as all-normal)."""
    rootp = Path(root)
    split_dir = next((rootp / s for s in
                      (split, split.capitalize(), split.lower(),
                       "testing/frames", "testing")
                      if (rootp / s).is_dir()), rootp / split)
    out = load_ucsd_gt(str(split_dir))
    if not out:
        vols = load_avenue_gt(root)
        out = {name: vols[i] for i, name in enumerate(video_names)
               if i < len(vols)}
    return out


def clip_labels_from_frames(clips, frame_labels: Dict[str, np.ndarray]
                            ) -> np.ndarray:
    """Clip-level labels: anomalous iff ANY frame in the window is anomalous
    (the standard VAD windowing convention).  Frames past the end of a
    ground-truth vector count as normal."""
    labels = np.zeros(len(clips), np.float32)
    for i, c in enumerate(clips):
        vec = frame_labels.get(c.video)
        if vec is None:
            continue
        window = vec[c.start:c.start + len(c.frames)]
        labels[i] = float(window.size > 0 and np.any(window > 0))
    return labels
