"""Synthetic clips and frame-folder trees, numpy only.

An own copy of `cvad_tpu/data/synthetic.py` (`_render_video`,
`make_synthetic_clips`, `write_synthetic_video_tree` and its PGM, PPM and
mask writers): normal clips are smooth moving blobs, anomalous ones move
erratically (and flash, in the 'easy' profile).  The code is the same
numpy, so the same seed gives bit-identical clips and labels
(tests/test_torch_port_trainer.py) and byte-identical trees
(tests/test_torch_port_data.py) in both packages.  PGM, PPM and ``.npy``
need numpy alone; TIFF, JPEG and PNG frames and BMP/PNG/TIFF masks are
written through PIL, imported where one is asked for.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np


def _render_video(rng: np.ndarray, t: int, h: int, w: int, c: int,
                  anomalous, return_masks: bool = False,
                  profile: str = "easy") -> np.ndarray:
    """Render one clip (T, H, W, C) float32 in [0, 1].

    `anomalous` is a bool (whole clip) or a (T,) per-frame bool array —
    per-frame flags produce within-video anomaly *segments*, which is what
    real UCSD/Avenue ground truth looks like.  With `return_masks`, also
    return (T, H, W) uint8 pixel masks (nonzero on the anomalous object in
    anomalous frames, zero elsewhere) — the ``Test00N_gt`` format.

    ``profile`` picks the task difficulty:

    - ``'easy'`` (default, the original fixture recipe): anomalies add
      intensity flashes + large positional jumps — trivially separable, for
      smoke/learnability tests.
    - ``'hard'``: both classes share IDENTICAL appearance statistics (same
      brightness, size, speed distribution, noise; no flash).  The only
      signal is motion *coherence*: normal blobs follow a smooth trajectory
      (small heading noise), anomalous blobs re-steer erratically at the
      same average speed.  Calibrated so supervised models land mid-AUC
      (~0.6-0.95) instead of saturating at 1.0."""
    anom = np.broadcast_to(np.asarray(anomalous, bool), (t,))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = rng.uniform(0.2, 0.8) * w
    cy = rng.uniform(0.2, 0.8) * h
    sigma = rng.uniform(0.08, 0.15) * min(h, w)
    frames = np.empty((t, h, w, c), np.float32)
    masks = np.zeros((t, h, w), np.uint8) if return_masks else None
    base = rng.uniform(0.05, 0.2)
    if profile == "hard":
        speed = rng.uniform(1.0, 3.0) * min(h, w) / 64.0
        theta = rng.uniform(0, 2 * np.pi)
        noise_sd = 0.03
    elif profile == "easy":
        vx = rng.uniform(-1.5, 1.5)
        vy = rng.uniform(-1.5, 1.5)
        noise_sd = 0.02
    else:
        raise ValueError(f"unknown synthetic profile {profile!r}")
    for i in range(t):
        if profile == "hard":
            # same speed either way; anomaly = erratic heading changes
            theta += rng.normal(0, 1.1 if anom[i] else 0.06)
            cx += speed * np.cos(theta)
            cy += speed * np.sin(theta)
            # reflective bounce (identical for both classes) so neither
            # class parks on the border
            if cx < 0 or cx > w - 1:
                cx = float(np.clip(cx, 0, w - 1))
                theta = np.pi - theta
            if cy < 0 or cy > h - 1:
                cy = float(np.clip(cy, 0, h - 1))
                theta = -theta
        elif anom[i]:
            # erratic jumps + speed bursts
            cx += vx * 4 + rng.normal(0, 0.15 * w)
            cy += vy * 4 + rng.normal(0, 0.15 * h)
        else:
            cx += vx
            cy += vy
        cx = float(np.clip(cx, 0, w - 1))
        cy = float(np.clip(cy, 0, h - 1))
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2))
        frame = base + 0.7 * blob
        if profile == "easy" and anom[i] and i % 3 == 0:
            frame = frame + 0.3  # intensity flash
        if masks is not None and anom[i]:
            masks[i] = (blob > 0.3).astype(np.uint8) * 255
        frame = np.clip(frame + rng.normal(0, noise_sd, (h, w)), 0, 1)
        if c == 1:
            frames[i, ..., 0] = frame
        else:
            for ch in range(c):
                frames[i, ..., ch] = np.clip(frame * (0.8 + 0.2 * ch / c), 0, 1)
    return (frames, masks) if return_masks else frames


def make_synthetic_clips(n: int, clip_len: int = 8, hw: Tuple[int, int] = (64, 64),
                         channels: int = 3, anomaly_rate: float = 0.5,
                         seed: int = 0, profile: str = "easy",
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(clips (N, T, H, W, C) f32, labels (N,) f32) with learnable separation."""
    rng = np.random.default_rng(seed)
    h, w = hw
    clips = np.empty((n, clip_len, h, w, channels), np.float32)
    labels = (rng.uniform(size=n) < anomaly_rate).astype(np.float32)
    for i in range(n):
        clips[i] = _render_video(rng, clip_len, h, w, channels, bool(labels[i]),
                                 profile=profile)
    return clips, labels
def write_synthetic_video_tree(root: str, splits=("Train", "Test"),
                               videos_per_split: int = 2,
                               frames_per_video: int = 24,
                               hw: Tuple[int, int] = (64, 64),
                               channels: int = 1, fmt: str = "pgm",
                               seed: int = 0, write_gt: bool = False,
                               gt_fmt: str = "pgm") -> str:
    """Write a UCSD-style frame-folder tree; returns the root path.

    With `write_gt`, anomalous test videos get frame-level anomaly
    *segments* (middle 25-75% of frames) and a sibling ``<video>_gt/``
    folder of per-frame pixel masks — the real UCSD Ped2 ground-truth
    layout the reference skips (``minicausal_vad_complete3.py:141-143``) —
    so the `ground_truth` label policy and the frame-AUC report are
    end-to-end testable without the real dataset."""
    rng = np.random.default_rng(seed)
    h, w = hw
    rootp = Path(root)
    for split in splits:
        for v in range(videos_per_split):
            vdir = rootp / split / f"{split}{v + 1:03d}"
            vdir.mkdir(parents=True, exist_ok=True)
            is_anom_video = split != "Train" and v % 2 == 0
            if write_gt and is_anom_video:
                flags = np.zeros(frames_per_video, bool)
                flags[frames_per_video // 4: (3 * frames_per_video) // 4] = True
            else:
                flags = np.full(frames_per_video, is_anom_video)
            video, masks = _render_video(rng, frames_per_video, h, w,
                                         channels, anomalous=flags,
                                         return_masks=True)
            if write_gt and split != "Train":
                gt_dir = rootp / split / (vdir.name + "_gt")
                gt_dir.mkdir(parents=True, exist_ok=True)
                for i in range(frames_per_video):
                    _write_mask(gt_dir / f"{i + 1:03d}.{gt_fmt}", masks[i],
                                gt_fmt)
            for i in range(frames_per_video):
                frame8 = (video[i] * 255).astype(np.uint8)
                path = vdir / f"{i + 1:03d}.{fmt}"
                if fmt == "npy":
                    np.save(str(path)[:-4] + ".npy", video[i])
                elif fmt == "pgm":
                    _write_pgm(path, frame8[..., 0] if channels >= 1 else frame8)
                elif fmt == "ppm":
                    rgb = (np.repeat(frame8, 3, -1) if channels == 1 else frame8)
                    _write_ppm(path, rgb[..., :3])
                elif fmt in ("tif", "tiff", "tif_lzw", "jpg", "png"):
                    # real-dataset formats (UCSD .tif / Avenue jpg+png),
                    # written via PIL like the original datasets were
                    from PIL import Image

                    arr = frame8[..., 0] if channels == 1 else frame8
                    kw = {"compression": "tiff_lzw"} if fmt == "tif_lzw" else {}
                    ext = "tif" if fmt == "tif_lzw" else fmt
                    Image.fromarray(arr).save(
                        str(path)[: -len(fmt)] + ext, **kw)
                else:
                    raise ValueError(f"unsupported fixture format {fmt!r}")
    return str(rootp)


def _write_mask(path: Path, mask: np.ndarray, fmt: str) -> None:
    if fmt == "pgm":
        _write_pgm(path, mask)
    elif fmt == "npy":
        np.save(str(path)[:-4] + ".npy", mask)
    else:  # bmp/png/tif — the real dataset mask formats, via PIL
        from PIL import Image

        Image.fromarray(mask).save(path)


def _write_pgm(path: Path, gray: np.ndarray) -> None:
    h, w = gray.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(gray, np.uint8).tobytes())


def _write_ppm(path: Path, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())
