"""Host frame decode + resize backends.

Port of `cvad_tpu/data/decode.py` (`resize_bilinear`, `decode_frame`,
`_read`, `_read_native`): the same backend order (native, then cv2, then
PIL) and the same zero frame where every backend fails, so the port's
frames equal `cvad_tpu`'s bit for bit.  The native core is the port's own
build of ``native/decoder.cpp`` (`cvad_tpu_torch.data.native_decoder`).
A host without cv2 and PIL decodes through the native core alone.

The reference's true input bottleneck is per-frame ``cv2.imread`` /
``PIL.Image.open`` in ``__getitem__`` (SURVEY.md §2 native-component note).
Backends, fastest available first:

- ``native``: the C++ decode/resize core (``native/decoder.cpp``) via ctypes —
  PGM/PPM/BMP/raw decode + SIMD-friendly bilinear resize + normalize in one
  pass, no Python per-pixel work;
- ``cv2`` / ``pil``: library decode for JPEG/PNG/TIFF;
- ``npy``: pre-decoded numpy frames (the fixture generator writes these too).

All backends return float32 HxWxC in [0, 1] at the requested size.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np


@functools.cache
def _cv2():
    try:
        import cv2

        return cv2
    except Exception:
        return None


@functools.cache
def _pil():
    try:
        from PIL import Image

        return Image
    except Exception:
        return None


def resize_bilinear(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Pure-numpy bilinear resize (align_corners=False, half-pixel centers —
    matches cv2.resize/INTER_LINEAR semantics), fallback when no backend."""
    h, w = img.shape[:2]
    oh, ow = hw
    if (h, w) == (oh, ow):
        return img
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if img.ndim == 2:
        img = img[..., None]
    tl = img[y0[:, None], x0[None, :]]
    tr = img[y0[:, None], x1[None, :]]
    bl = img[y1[:, None], x0[None, :]]
    br = img[y1[:, None], x1[None, :]]
    top = tl + (tr - tl) * wx[..., None]
    bot = bl + (br - bl) * wx[..., None]
    return top + (bot - top) * wy[..., None]


def decode_frame(path: str, size: Tuple[int, int], grayscale: bool,
                 backend: str = "auto") -> np.ndarray:
    """Decode one frame file -> float32 (H, W, C) in [0, 1].

    On any decode failure returns a zero frame, preserving the reference's
    fallback (``minicausal_vad_complete3.py:205-207``,
    ``causal_anomaly_detection1.py:104-105``).
    """
    c = 1 if grayscale else 3
    try:
        arr = _read(path, grayscale, backend, size)
        if arr is None:
            raise IOError(f"decode failed: {path}")
        arr = resize_bilinear(arr.astype(np.float32), size)
        if grayscale and arr.shape[-1] != 1:
            arr = arr.mean(axis=-1, keepdims=True)
        if not grayscale and arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        return np.clip(arr / 255.0, 0.0, 1.0).astype(np.float32)
    except Exception:
        return np.zeros((size[0], size[1], c), np.float32)


def _read(path: str, grayscale: bool, backend: str,
          size: Optional[Tuple[int, int]] = None) -> Optional[np.ndarray]:
    if path.endswith(".npy"):
        arr = np.load(path)
        return arr if arr.ndim == 3 else arr[..., None]
    if backend in ("auto", "native"):
        arr = _read_native(path, size, 1 if grayscale else 3)
        if arr is not None:
            return arr
        if backend == "native":
            return None
    if backend in ("auto", "cv2") and _cv2() is not None:
        cv2 = _cv2()
        flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            return None
        if img.ndim == 2:
            return img[..., None]
        return img[..., ::-1]  # BGR -> RGB
    if backend in ("auto", "pil") and _pil() is not None:
        Image = _pil()
        with Image.open(path) as im:
            im = im.convert("L" if grayscale else "RGB")
            arr = np.asarray(im)
        return arr if arr.ndim == 3 else arr[..., None]
    return None


def _read_native(path: str, size: Optional[Tuple[int, int]] = None,
                 channels: Optional[int] = None) -> Optional[np.ndarray]:
    """C++ decoder path; covers whatever the built core supports — PNM/BMP/
    TIFF always, JPEG/PNG when the codec headers were present at build time
    (``native_decoder.supported_suffixes``).  Returns None for other formats
    so the PIL/cv2 fallbacks take over.

    When ``size``/``channels`` are given, the C++ core also does the
    bilinear resize and gray<->rgb mapping (bit-compatible with
    ``resize_bilinear``: tests/test_torch_port_data.py; bilinear commutes with
    channel averaging), so the caller's numpy resize becomes a no-op: the
    per-frame path would otherwise be SLOWER than PIL (the numpy resize
    dominated, scripts/bench_decode.py)."""
    from cvad_tpu_torch.data.native_decoder import (decode_file,
                                                    load_library,
                                                    supported_suffixes)

    try:
        lib = load_library()
    except Exception:
        return None
    if lib is None:
        return None

    if not path.lower().endswith(supported_suffixes()):
        return None
    return decode_file(lib, path, size=size, channels=channels)
