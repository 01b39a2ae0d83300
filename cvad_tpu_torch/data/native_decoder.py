"""ctypes binding of the C++ decode core (``native/decoder.cpp``).

Port of `cvad_tpu/data/native_decoder.py` (`load_library`,
`supported_suffixes`, `decode_file`, `decode_clip`).  The port builds its
own library from ``native/decoder.cpp`` at first use, with the flags of
``native/Makefile``, into ``cvad_tpu_torch/build/`` (listed in
``.gitignore``): a library linked on another host may miss that host's
codec libraries, so the port never loads one it did not build.  The file
name carries a hash of the source and the flags, so an edited source is
rebuilt.  PNM, BMP and TIFF decode everywhere; JPEG and PNG only where the
host had the codec headers when the library was built.  Nothing runs when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]

_lock = threading.Lock()
_loaded: List[Optional[ctypes.CDLL]] = []  # [] until the first attempt
# why the first attempt gave None (the compiler's stderr or the loader's
# error), "" where it loaded
last_error = ""


def link_flags() -> List[str]:
    """``native/Makefile``'s LDFLAGS: a codec is linked only where its
    header exists (the source guards it with ``__has_include``)."""
    flags = ["-shared", "-lpthread"]
    if Path("/usr/include/jpeglib.h").is_file():
        flags.append("-ljpeg")
    if Path("/usr/include/png.h").is_file():
        flags.append("-lpng")
    return flags


def library_path() -> Path:
    """Where this host's build of the decoder lives (or will)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + link_flags()).encode())
    return BUILD_DIR / f"libcvaddecode-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), *link_flags(), "-o",
                    str(tmp)], check=True, capture_output=True, text=True,
                   timeout=300)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building first if needed) the decoder library; None where it
    cannot be built or loaded, as in `cvad_tpu`, with the cause in
    `last_error`.  The first attempt's outcome holds for the life of the
    process."""
    global last_error
    with _lock:
        if _loaded:
            return _loaded[0]
        lib = None
        out = library_path()
        try:
            if not out.is_file():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except subprocess.CalledProcessError as e:
            last_error = f"{' '.join(e.cmd)} failed:\n{e.stderr}"
        except (OSError, subprocess.SubprocessError) as e:
            last_error = f"{type(e).__name__}: {e}"
        if lib is not None:
            _declare(lib)
        _loaded.append(lib)
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    lib.cvad_decode_frame.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cvad_decode_frame.restype = ctypes.c_int
    lib.cvad_probe.argtypes = ([ctypes.c_char_p]
                               + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.cvad_probe.restype = ctypes.c_int
    lib.cvad_decode_clip.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cvad_decode_clip.restype = ctypes.c_int
    lib.cvad_codecs.argtypes = []
    lib.cvad_codecs.restype = ctypes.c_int


def supported_suffixes() -> tuple:
    """File extensions the loaded native core decodes: PNM, BMP and TIFF
    always (a hand-rolled TIFF reader: none/LZW/PackBits strips, both
    endians); JPEG and PNG where the codec headers were present at build
    time (`cvad_codecs` bitmask: 1 JPEG, 2 PNG)."""
    lib = load_library()
    if lib is None:
        return ()
    suffixes = [".pgm", ".ppm", ".bmp", ".tif", ".tiff"]
    mask = lib.cvad_codecs()
    if mask & 1:
        suffixes += [".jpg", ".jpeg"]
    if mask & 2:
        suffixes += [".png"]
    return tuple(suffixes)


def decode_file(lib: ctypes.CDLL, path: str,
                size: Optional[tuple] = None, channels: Optional[int] = None
                ) -> Optional[np.ndarray]:
    """Decode one frame at its own or the requested size -> float32 HWC in
    [0, 255] (decode.py normalises); None where the core cannot decode
    it."""
    if size is not None and channels is not None:
        # fully specified output: no probe (a second read of the file);
        # cvad_decode_frame fails cleanly on input it cannot decode
        oh, ow = size
        oc = channels
    else:
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        if lib.cvad_probe(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c)) != 0:
            return None
        oh, ow = size if size else (h.value, w.value)
        oc = channels if channels else c.value
    out = np.empty((oh, ow, oc), np.float32)
    rc = lib.cvad_decode_frame(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        oh, ow, oc)
    if rc != 0:
        return None
    return out * 255.0


def decode_clip(paths: Sequence[str], size: tuple, channels: int,
                nthreads: int = 4) -> Optional[np.ndarray]:
    """Decode a whole clip in one C call -> (T, H, W, C) float32 in [0, 1];
    None where the library is unavailable.  A frame the core cannot decode
    comes out as zeros, as in `cvad_tpu`."""
    lib = load_library()
    if lib is None:
        return None
    t = len(paths)
    oh, ow = size
    out = np.empty((t, oh, ow, channels), np.float32)
    arr = (ctypes.c_char_p * t)(*[p.encode() for p in paths])
    lib.cvad_decode_clip(arr, t,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         oh, ow, channels, nthreads)
    return out
