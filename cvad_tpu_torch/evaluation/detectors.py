"""Person-detection backends for bbox localization.

Port of `cvad_tpu/evaluation/detectors.py` (the reference's ladder,
``avenue_training_script_bbox.py:30-48,157-326``): yolov5 -> OpenCV-DNN ->
the motion/contour detector, each a plain callable ``frame -> [Detection]``
behind one registry.  The motion detector has a cv2 implementation and a
numpy/scipy one, so localization works without optional libraries.  All
of it runs on the host.

The yolov5 rung differs from `cvad_tpu`'s: it loads only from a local
checkout of the yolov5 hub repository and local weights under
`weights_dir` (``torch.hub.load(..., source="local")``), never from the
network.  `cvad_tpu` asks ``torch.hub`` for ``ultralytics/yolov5``, which
is a fetch; offline it lands on the motion detector, and so does the port
when nothing is local.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Detection:
    bbox: List[int]  # [x1, y1, x2, y2]
    confidence: float

    @property
    def center(self):
        return ((self.bbox[0] + self.bbox[2]) // 2,
                (self.bbox[1] + self.bbox[3]) // 2)


def _cv2():
    try:
        import cv2

        return cv2
    except ImportError:
        return None


def detect_persons_motion(frame: np.ndarray, max_out: int = 3
                          ) -> List[Detection]:
    """Contour/edge detector (reference ``:281-312``): Canny edges ->
    external contours -> person-shaped boxes (area > 100, w > 10, h > 20,
    aspect 1.2-4.0), at most `max_out`.  Without cv2, `_detect_motion_numpy`."""
    cv2 = _cv2()
    if cv2 is None:
        return _detect_motion_numpy(frame, max_out)
    gray = frame if frame.ndim == 2 else cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    blur = cv2.GaussianBlur(gray, (21, 21), 0)
    edges = cv2.Canny(blur, 50, 150)
    contours, _ = cv2.findContours(edges, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    persons = []
    for contour in contours:
        if cv2.contourArea(contour) > 100:
            x, y, w, h = cv2.boundingRect(contour)
            ar = h / w if w > 0 else 0
            if w > 10 and h > 20 and 1.2 < ar < 4.0:
                persons.append(Detection([x, y, x + w, y + h], 0.5))
    return persons[:max_out]


def _detect_motion_numpy(frame: np.ndarray, max_out: int) -> List[Detection]:
    """No-cv2 detector: gradient-magnitude blobs by scipy's connected
    components, the largest first.  No detections without scipy."""
    try:
        from scipy import ndimage
    except ImportError:
        return []

    gray = frame if frame.ndim == 2 else frame.mean(axis=-1)
    gray = gray.astype(np.float32)
    gy, gx = np.gradient(gray)
    mag = np.hypot(gx, gy)
    mask = mag > max(mag.mean() + 2 * mag.std(), 1e-3)
    labels, _ = ndimage.label(mask)
    persons = []
    for y, x in ndimage.find_objects(labels):
        w, h = x.stop - x.start, y.stop - y.start
        if w > 10 and h > 20 and 1.2 < (h / max(w, 1)) < 4.0 and w * h > 100:
            persons.append(Detection([x.start, y.start, x.stop, y.stop], 0.5))
    persons.sort(key=lambda d: (d.bbox[2] - d.bbox[0]) * (d.bbox[3] - d.bbox[1]),
                 reverse=True)
    return persons[:max_out]


def detect_persons_opencv_dnn(frame: np.ndarray, net=None, conf: float = 0.2
                              ) -> List[Detection]:
    """OpenCV-DNN YOLO backend (reference ``:234-279``) over a preloaded
    `net`; no detections without cv2 or a net."""
    cv2 = _cv2()
    if cv2 is None or net is None:
        return []
    h, w = frame.shape[:2]
    blob = cv2.dnn.blobFromImage(frame, 1 / 255.0, (416, 416), swapRB=True,
                                 crop=False)
    net.setInput(blob)
    outputs = net.forward(net.getUnconnectedOutLayersNames())
    boxes, confs = [], []
    for output in outputs:
        for det in output:
            scores = det[5:]
            cid = int(np.argmax(scores))
            c = float(scores[cid])
            if cid == 0 and c > conf:
                cx, cy = int(det[0] * w), int(det[1] * h)
                bw, bh = int(det[2] * w), int(det[3] * h)
                boxes.append([cx - bw // 2, cy - bh // 2, bw, bh])
                confs.append(c)
    idx = cv2.dnn.NMSBoxes(boxes, confs, conf, 0.2)
    out = []
    for i in np.asarray(idx).flatten():
        x, y, bw, bh = boxes[i]
        out.append(Detection([x, y, x + bw, y + bh], confs[i]))
    return out


_REGISTRY: Dict[str, Callable] = {}


def register_detector(name: str, fn: Callable) -> None:
    _REGISTRY[name] = fn


register_detector("motion", detect_persons_motion)


def get_detector(backend: str = "auto") -> Callable:
    """A registered detector by name, or the ladder's pick for 'auto'."""
    if backend in _REGISTRY:
        return _REGISTRY[backend]
    if backend == "auto":
        return setup_detector("auto")[0]
    raise KeyError(f"unknown detector backend {backend!r}; "
                   f"registered: {sorted(_REGISTRY)}")


def _local_yolov5(weights_dir: Optional[str]) -> Optional[Callable]:
    """yolov5 from a local hub checkout (``weights_dir/yolov5`` with its
    ``hubconf.py``) and local weights (``weights_dir/yolov5s.pt``), or None
    where either is missing.  The weights are passed by path to the hub's
    ``custom`` entry, which reads them from disk: the ``yolov5s`` entry
    would download them when they are not in the working directory."""
    if not weights_dir:
        return None
    repo = os.path.join(weights_dir, "yolov5")
    weights = os.path.join(weights_dir, "yolov5s.pt")
    if not (os.path.isfile(os.path.join(repo, "hubconf.py"))
            and os.path.isfile(weights)):
        return None
    import torch

    model = torch.hub.load(repo, "custom", path=weights, source="local",
                           verbose=False)

    def yolo(frame, _m=model):
        persons = []
        for *xyxy, conf, cls in _m(frame).xyxy[0].tolist():
            if int(cls) == 0 and conf > 0.2:
                persons.append(Detection([int(v) for v in xyxy], conf))
        return persons

    return yolo


def setup_detector(backend: str = "auto", weights_dir: Optional[str] = None):
    """The backend ladder (reference ``avenue_training_script_bbox.py
    :30-48,157-208``): yolov5 -> OpenCV-DNN -> motion/contour, each of the
    first two from local files under `weights_dir` only.  Returns
    (callable, backend_name); 'yolov5' or 'opencv' asked by name without
    their files raise."""
    if backend in ("auto", "yolov5"):
        yolo = _local_yolov5(weights_dir)
        if yolo is not None:
            return yolo, "yolov5"
        if backend == "yolov5":
            raise RuntimeError("yolov5 backend unavailable: it needs a local "
                               "hub checkout and weights under weights_dir "
                               "(yolov5/hubconf.py, yolov5s.pt)")
    if backend in ("auto", "opencv"):
        cv2 = _cv2()
        if cv2 is not None and weights_dir:
            cfg = os.path.join(weights_dir, "yolov4-tiny.cfg")
            wts = os.path.join(weights_dir, "yolov4-tiny.weights")
            if os.path.exists(cfg) and os.path.exists(wts):
                net = cv2.dnn.readNetFromDarknet(cfg, wts)
                return (lambda frame: detect_persons_opencv_dnn(frame, net),
                        "opencv")
        if backend == "opencv":
            raise RuntimeError("opencv-dnn backend needs local yolov4 weights")
    return detect_persons_motion, "motion"
