"""HTTP serving front end for online frame interpolation, port of
`vfi_tpu/serve/server.py`: the same protocol, content types, body codecs,
body limit, status codes and JSON errors.

Stdlib-only (ThreadingHTTPServer): each connection thread blocks on the
MicroBatcher future while the single device worker launches coalesced,
fixed-shape batches (see batcher.py).

Protocol
--------
POST /v1/interpolate   body = u32_be(len(png0)) | png0 | png1
                       -> 200, image/png (the temporal midpoint)
POST /v1/interpolate   Content-Type: application/x-vfi-raw-seq
                       body = u16_be(H) | u16_be(W) | N+1 raw u8 H*W*3 frames
                       -> 200, x-vfi-raw-seq (N u8 midpoints, consecutive
                       pairs) — ships each video frame over the wire and
                       to the device once instead of twice
POST /v1/interpolate   Content-Type: application/x-vfi-raw
                       body = u16_be(h) | u16_be(w) | rgb0 | rgb1
                       (two tightly packed u8 H*W*3 RGB frames)
                       -> 200, application/x-vfi-raw (u8 H*W*3 midpoint)
GET  /healthz          -> 200 JSON {status, devices, platform, buckets, ...}
GET  /stats            -> 200 JSON batching statistics (see BatcherStats)

Frames are 8-bit RGB of identical dimensions. The PNG route decodes and
encodes with the port's own codec (`vfi_tpu_torch.native`: any PNG,
decoded as Pillow's `convert("RGB")` decodes it; responses at
`png_compress_level`, default 1); other image formats are refused with a
400. The raw routes skip the image codec entirely — the right wire format
when the caller already holds decoded frames (e.g. a video pipeline).
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from vfi_tpu_torch import native
from vfi_tpu_torch.serve.batcher import MicroBatcher

MAX_BODY_BYTES = 256 << 20  # two 4K RGBA PNGs fit with a wide margin


def _decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (the batcher converts to the
    engine's io dtype; uint8 engines take it as it is). Anything but a
    PNG raises ValueError."""
    return native.decode_png_rgb(data)


def _to_u8(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0, 1] or uint8 -> uint8."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint8:
        return frame
    return np.clip(np.asarray(frame, np.float32) * 255.0 + 0.5,
                   0, 255).astype(np.uint8)


def _encode_png(frame: np.ndarray, compress_level: int = 1) -> bytes:
    """(H, W, 3) float [0, 1] or uint8 -> PNG bytes."""
    return native.encode_png_rgb(_to_u8(frame), compress_level)


RAW_CONTENT_TYPE = "application/x-vfi-raw"
SEQ_CONTENT_TYPE = "application/x-vfi-raw-seq"


def encode_raw_body(f0: np.ndarray, f1: np.ndarray) -> bytes:
    """Client-side helper: (H, W, 3) u8 RGB pair -> raw request body."""
    if f0.shape != f1.shape or f0.ndim != 3 or f0.shape[2] != 3:
        raise ValueError(f"need two equal (H, W, 3) frames, got "
                         f"{f0.shape} vs {f1.shape}")
    h, w = f0.shape[:2]
    return (struct.pack(">HH", h, w)
            + np.ascontiguousarray(f0, np.uint8).tobytes()
            + np.ascontiguousarray(f1, np.uint8).tobytes())


def split_raw_body(body: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Parse a raw request body -> two (H, W, 3) uint8 frames."""
    if len(body) < 4:
        raise ValueError("raw body shorter than the 4-byte dims prefix")
    h, w = struct.unpack(">HH", body[:4])
    n = h * w * 3
    if len(body) != 4 + 2 * n:
        raise ValueError(f"raw body is {len(body)} bytes, expected "
                         f"4 + 2*{n} for {h}x{w}")
    def frame(off):
        return np.frombuffer(body, np.uint8, count=n,
                             offset=off).reshape(h, w, 3)
    return frame(4), frame(4 + n)


def split_pair_body(body: bytes) -> tuple[bytes, bytes]:
    """Parse the length-prefixed two-PNG request body."""
    if len(body) < 4:
        raise ValueError("body shorter than the 4-byte length prefix")
    (n0,) = struct.unpack(">I", body[:4])
    if n0 == 0 or 4 + n0 >= len(body):
        raise ValueError(f"invalid first-frame length {n0} for "
                         f"{len(body)}-byte body")
    return body[4:4 + n0], body[4 + n0:]


def encode_seq_body(frames: np.ndarray) -> bytes:
    """Client-side helper: (N+1, H, W, 3) u8 RGB -> sequence request body
    (same 4-byte dims prefix as the raw route; the frame count is implied
    by the body length)."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[0] < 2 or frames.shape[3] != 3:
        raise ValueError(f"need (N+1>=2, H, W, 3) u8 frames, got "
                         f"{frames.shape}")
    h, w = frames.shape[1:3]
    return struct.pack(">HH", h, w) + frames.tobytes()


def split_seq_body(body: bytes) -> np.ndarray:
    """Parse a sequence request body -> (N+1, H, W, 3) uint8 frames."""
    if len(body) < 4:
        raise ValueError("seq body shorter than the 4-byte dims prefix")
    h, w = struct.unpack(">HH", body[:4])
    fsz = h * w * 3
    if fsz == 0 or (len(body) - 4) % fsz != 0:
        raise ValueError(f"seq body is {len(body)} bytes, not a multiple "
                         f"of {fsz}-byte {h}x{w} frames + 4")
    n1 = (len(body) - 4) // fsz
    if n1 < 2:
        raise ValueError("seq body needs >= 2 frames")
    return np.frombuffer(body, np.uint8, offset=4).reshape(n1, h, w, 3)


def encode_pair_body(png0: bytes, png1: bytes) -> bytes:
    """Client-side helper: build a /v1/interpolate request body."""
    return struct.pack(">I", len(png0)) + png0 + png1


class _Handler(BaseHTTPRequestHandler):
    # the server instance injects itself as class attribute `vfi`
    vfi: "InterpolationServer"

    def log_message(self, fmt, *args):  # route through the server's logger
        if self.vfi.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj: dict):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path == "/healthz":
            self._reply_json(200, self.vfi.health())
        elif self.path == "/stats":
            self._reply_json(200, self.vfi.batcher.stats.snapshot())
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 - http.server API
        if self.path.split("?")[0] != "/v1/interpolate":
            self._reply_json(404, {"error": f"unknown path {self.path}"})
            return
        # media-type match only: HTTP allows parameters ("; charset=...")
        # and case-insensitive types, which an exact == would misroute into
        # the length-prefixed-PNG parser with a confusing 400
        ctype = self.headers.get("Content-Type", "").split(";")[0].strip().lower()
        raw = ctype == RAW_CONTENT_TYPE
        seq = ctype == SEQ_CONTENT_TYPE
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= MAX_BODY_BYTES:
                raise ValueError(f"bad Content-Length {length}")
            body = self.rfile.read(length)
            if seq:
                frames = split_seq_body(body)
            elif raw:
                f0, f1 = split_raw_body(body)
            else:
                png0, png1 = split_pair_body(body)
                f0, f1 = _decode_png(png0), _decode_png(png1)
            if not seq and f0.shape != f1.shape:
                raise ValueError(f"frame shapes differ: {f0.shape} vs {f1.shape}")
        except Exception as e:  # noqa: BLE001 - malformed request
            self._reply_json(400, {"error": str(e)})
            return
        try:
            if seq:
                mids = self.vfi.batcher.interpolate_sequence(
                    frames, timeout=self.vfi.request_timeout)
                self._reply(200,
                            np.concatenate([_to_u8(m)[None] for m in mids]
                                           ).tobytes(), SEQ_CONTENT_TYPE)
                return
            mid = self.vfi.batcher.interpolate(f0, f1,
                                               timeout=self.vfi.request_timeout)
        except Exception as e:  # noqa: BLE001 - engine/timeout failure
            self._reply_json(500, {"error": str(e)})
            return
        if raw:
            self._reply(200, _to_u8(mid).tobytes(), RAW_CONTENT_TYPE)
        else:
            self._reply(200, _encode_png(mid, self.vfi.png_compress_level),
                        "image/png")


class InterpolationServer:
    """Owns the HTTP listener and the MicroBatcher.

    Args:
      engine: FrameInterpolator (any kernel configuration).
      host/port: bind address; port 0 picks a free port (see `.port`).
      request_timeout: per-request ceiling on waiting for the device.
      batcher kwargs: max_batch / max_delay_ms / pad_to_max /
        max_px_per_launch (the memory guard).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 8, max_delay_ms: float = 5.0,
                 pad_to_max: bool = True, request_timeout: float = 120.0,
                 verbose: bool = False, png_compress_level: int = 1,
                 max_px_per_launch: int | None = None):
        self.batcher = MicroBatcher(engine, max_batch=max_batch,
                                    max_delay_ms=max_delay_ms,
                                    pad_to_max=pad_to_max,
                                    max_px_per_launch=max_px_per_launch)
        self.request_timeout = request_timeout
        self.verbose = verbose
        self.png_compress_level = png_compress_level
        handler = type("BoundHandler", (_Handler,), {"vfi": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def health(self) -> dict:
        """The engine's device type, the devices of that type (the card
        count on `cuda`) and the card's name, and the batcher's
        settings."""
        dev = torch.device(getattr(self.batcher.engine, "device", "cpu"))
        cuda = dev.type == "cuda"
        return {
            "status": "ok",
            "platform": dev.type,
            "devices": torch.cuda.device_count() if cuda else 1,
            "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "max_batch": self.batcher.max_batch,
            "max_px_per_launch": self.batcher.max_px,
            "buckets": sorted(self.batcher.stats.per_bucket),
        }

    def warmup(self, shapes) -> None:
        """Run each route's launches once ahead of traffic.

        Each entry is either a pair-bucket shape `(height, width)` or a
        sequence-route shape `(n_frames, height, width)` — the latter runs
        the launches an (n_frames)-frame x-vfi-raw-seq request takes
        (including the guard's chunk shapes)."""
        for shape in shapes:
            if len(shape) == 3:
                n1, h, w = shape
                self.batcher.warmup_sequence(n1, h, w)
            else:
                h, w = shape
                self.batcher.warmup(h, w)

    def start(self) -> "InterpolationServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="vfi-http")
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join()
        self._httpd.server_close()
        self.batcher.close()
