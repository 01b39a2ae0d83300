"""Stdlib HTTP front-end for the port's clip-scoring service.

Port of `cvad_tpu/evaluation/http_service.py`: a
:class:`~cvad_tpu_torch.evaluation.serving.ClipScoringService` (bucket-padded
batching) behind a plain HTTP endpoint, with the dynamic-batching
``BatchingServer`` coalescing concurrent requests into single device
batches.  Standard library only:

- ``GET  /healthz`` -> ``{"ok": true, "buckets": [...], "clip_shape": [...]}``
- ``GET  /stats``   -> batching counters (requests/clips/batches/errors,
  score seconds) — ``clips_total / batches_total`` shows coalescing
- ``POST /score``   -> scores and graphs (``?graphs=0`` omits the graphs)

``POST /score`` accepts either

- ``application/octet-stream``: an ``.npz`` payload (``np.savez``) with a
  ``clips`` array of shape (N, T, H, W, C), or a raw ``.npy`` array —
  float32 values in [0, 1], or uint8 raw pixels (0-255; normalized on
  device, 4x smaller payload and host->device transfer);
- ``application/json``: ``{"clips": [[...]]}`` nested lists (small
  payloads / debugging).

and returns JSON ``{"scores": [...], "graphs": [[...]] | null, "n": N}``.

Family B's and C's services return ``"graphs": null``: their scorers have
no graph; an exported family-A scorer returns its detections there, as
`cvad_tpu`'s does.  The port serves family-D and family-B ``.pth``
checkpoints, and exported scorers (``cli export``) of every family, which
carry their own clip shape; start it with::

    python -m cvad_tpu_torch.cli serve best_improved_model.pth --port 8700
    python -m cvad_tpu_torch.cli serve --family b CKPT.pth --port 8700
    python -m cvad_tpu_torch.cli serve scorer.pt2 --port 8700
"""

from __future__ import annotations

import io
import json
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from cvad_tpu_torch.evaluation.serving import (BatchingServer,
                                               ClipScoringService)

# (T, H, W, C) of one clip per family (`cvad_tpu`'s table, :47-53)
FAMILY_CLIP_SHAPES = {"a": (16, 240, 360, 1), "b": (8, 64, 64, 1),
                      "c": (8, 64, 64, 1), "d": (8, 64, 64, 3),
                      "e": (8, 64, 64, 3)}


def service_from_path(path: str, family: str = "d",
                      buckets=(1, 8, 32, 128), device=None
                      ) -> ClipScoringService:
    """A scoring service over a reference-format ``.pth`` checkpoint of
    family D or B, on `device` (CUDA unless the caller asks for the CPU),
    or over an exported scorer of any family (`serving.export_scorer` and
    the family exporters, ``cli export``), which runs on the device it was
    exported on at its own clip shape; `family` and `device` matter only
    for a ``.pth``.  The two are told apart by their zip members, not by
    their first bytes (both are zip files).  Family B scores against the
    memory bank the checkpoint holds (all ``memory_fill`` rows of a port
    checkpoint; ``memory_ptr`` rows of a reference one) and returns scores
    only.  A ``.pth`` of family A, C or E raises `ValueError`: as in
    `cvad_tpu`, those families serve from an exported scorer."""
    if servable_kind(path, family) == "artefact":
        with open(path, "rb") as f:
            return ClipScoringService.from_exported(f.read(), buckets=buckets)
    return ClipScoringService.from_torch_checkpoint(
        path, family, device=device, buckets=buckets,
        clip_shape=FAMILY_CLIP_SHAPES[family])


def servable_kind(path: str, family: str = "d") -> str:
    """`checkpoint_kind` of a file to serve, with a ``.pth`` of a family
    other than D and B refused by a `ValueError` that names ``cli export``
    (those families serve from an exported scorer, as in `cvad_tpu`)."""
    kind = checkpoint_kind(path)
    if kind == "pth" and family not in ("d", "b"):
        raise ValueError(f"no direct-checkpoint serving path for family "
                         f"{family!r}; run 'python -m cvad_tpu_torch.cli "
                         f"export --family {family}' and serve the exported "
                         f"scorer")
    return kind


def artefact_kind(archive: zipfile.ZipFile) -> str:
    """'artefact' for a `torch.export.save` archive, 'pth' for a
    `torch.save` one, by their members (both are zip files)."""
    names = archive.namelist()
    if any(n.endswith("/archive_format") for n in names):
        return "artefact"
    if any(n.endswith("/data.pkl") or n == "data.pkl" for n in names):
        return "pth"
    raise ValueError("a zip file that is neither a torch.export archive "
                     "nor a torch.save checkpoint")


def checkpoint_kind(path: str) -> str:
    """'artefact' (a `torch.export.save` archive) or 'pth' (a `torch.save`
    checkpoint, zip or legacy pickle); an empty or unreadable file raises
    `ValueError`."""
    with open(path, "rb") as f:
        head = f.read(2)
    if not head:
        raise ValueError(f"{path}: empty file is not a checkpoint or an "
                         f"exported scorer")
    if head[:1] == b"\x80":  # a legacy (non-zip) torch.save pickle
        return "pth"
    try:
        with zipfile.ZipFile(path) as z:
            return artefact_kind(z)
    except (zipfile.BadZipFile, ValueError) as e:
        raise ValueError(f"{path}: not a torch checkpoint or an exported "
                         f"scorer ({e})") from e


def _parse_clips(body: bytes, content_type: str,
                 clip_shape: Tuple[int, ...]) -> np.ndarray:
    if content_type.startswith("application/json"):
        clips = np.asarray(json.loads(body.decode())["clips"], np.float32)
    else:
        f = np.load(io.BytesIO(body), allow_pickle=False)
        raw = np.asarray(f["clips"] if hasattr(f, "files") else f)
        # uint8 payloads are raw 0-255 pixels (4x smaller on the wire AND
        # host->device; normalized on device) — preserve the dtype so the
        # batching worker keeps them in their own device batch
        clips = raw if raw.dtype == np.uint8 else np.asarray(raw, np.float32)
    # float clips must already be normalized: a client shipping raw 0-255
    # pixels as floats/ints (easy to do via JSON) would silently score
    # 255x-out-of-domain inputs — reject with the fix spelled out
    if clips.dtype != np.uint8 and clips.size and float(clips.max()) > 1.5:
        raise ValueError(
            f"float clips must be normalized to [0, 1] (got max "
            f"{float(clips.max()):.1f}); send raw 0-255 pixels as a uint8 "
            f"npz payload instead")
    # reject wrong shapes BEFORE they reach the shared batching worker: a
    # mismatched request co-batched with valid traffic would fail the whole
    # device batch
    if clips.ndim != 5 or clips.shape[1:] != tuple(clip_shape):
        raise ValueError(f"clips must be (N,) + {tuple(clip_shape)}; "
                         f"got {clips.shape}")
    return clips


def _finite_or_null(arr: np.ndarray):
    """JSON-safe nested lists: non-finite values become null (json.dumps
    would otherwise emit non-RFC 'NaN'/'Infinity' literals strict parsers
    reject)."""
    a = np.asarray(arr, np.float64)
    out = a.astype(object)
    out[~np.isfinite(a)] = None
    return out.tolist()


class ScoringHTTPServer:
    """Threaded HTTP server over a :class:`BatchingServer`.

    ``port=0`` binds an ephemeral port (see ``.port``).  Concurrent POSTs
    coalesce into one device batch via the batching worker — the HTTP
    threads block on the per-request event, so N small clients cost one
    device batch, not N.
    """

    def __init__(self, service: ClipScoringService, host: str = "127.0.0.1",
                 port: int = 8700, max_wait_ms: float = 2.0,
                 max_body: int = 1 << 30, request_timeout: float = 300.0):
        # request_timeout covers a cold first call (the kernel build and
        # cuDNN set-up); warmup() avoids paying it on live traffic
        self.service = service
        self.batcher = BatchingServer(service, max_wait_ms=max_wait_ms)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._reply(
                        200, {"ok": True,
                              "buckets": list(outer.service.buckets),
                              "clip_shape": list(outer.service.clip_shape)})
                if self.path == "/stats":
                    return self._reply(200, outer.batcher.stats())
                self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                from urllib.parse import parse_qs, urlsplit

                url = urlsplit(self.path)
                if url.path != "/score":
                    return self._reply(404, {"error": "unknown path"})
                # ?graphs=0 skips the adjacency matrices in the reply (only
                # the reply serialization; the device computes them anyway)
                want_graphs = parse_qs(url.query).get(
                    "graphs", ["1"])[0].lower() not in ("0", "false", "no",
                                                        "off")
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    return self._reply(400, {"error": "bad Content-Length"})
                if n <= 0 or n > max_body:
                    return self._reply(413, {"error": f"bad body size {n}"})
                try:
                    clips = _parse_clips(
                        self.rfile.read(n),
                        self.headers.get("Content-Type", ""),
                        outer.service.clip_shape)
                except Exception as e:  # noqa: BLE001 — surface to client
                    return self._reply(400, {"error": str(e)})
                try:
                    res = outer.batcher.submit(clips,
                                               timeout=request_timeout)
                except TimeoutError as e:
                    # server-side overload, not a client fault
                    return self._reply(503, {"error": str(e)})
                if res.error is not None:  # device batch failed
                    return self._reply(500, {"error": res.error})
                self._reply(200, {
                    "scores": _finite_or_null(res.scores),
                    "graphs": (None if res.graphs is None or not want_graphs
                               else _finite_or_null(res.graphs)),
                    "n": int(len(res.scores)),
                })

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        """Serve in a daemon thread; returns (host, port)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.host, self.port

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.batcher.close()
