"""The port's PNG codec and the loader's crop/flip/normalize core.

`decode_png_rgb`: chunk parsing and inflate in Python (the standard `zlib`
module), scanline unfilter, Adam7 and RGB expansion in C++ (`png.cpp`),
bound with ctypes. It takes every bit depth and colour type the format
allows, interlaced or not, and gives what Pillow's `convert("RGB")` gives
(`png.cpp` lists the rules). `encode_png_rgb`: filter type 0 and `zlib`
at a given level, in Python. `crop_flip_normalize`: the counterpart of
`vfi_tpu.native.crop_flip_normalize`, in C++ (`png.cpp`), bit-equal to
it; `available` says whether the library builds and loads.

The library is compiled from `png.cpp` with the host's C++ compiler on
first use into `build/vfi_tpu_torch/native/<key>/` beside the package (a
git-ignored directory), keyed by a hash of the source and the flags. It
needs no zlib header. A PNG it cannot read raises ValueError; every
function but `available` raises RuntimeError where the library cannot
build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "png.cpp"
BUILD_ROOT = SRC.parents[2] / "build" / "vfi_tpu_torch" / "native"
LIB_NAME = "libvfi_png.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# Samples per pixel of each colour type; Adam7's passes (x0, y0, dx, dy).
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# Largest image taken: 2^28 pixels (16K x 16K).
MAX_PX = 1 << 28

_lib = None
_load_lock = threading.Lock()


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (CXX, g++, c++, clang++): the "
                       "PNG decoder cannot build")


def build() -> Path:
    """Compile the library if its keyed build is missing; return its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    res = subprocess.run([_compiler(), *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the PNG decoder failed "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load():
    """The loaded library, building it on first use. Thread-safe: the
    server's handler threads decode at once, and one build (to one
    temporary file a process) must serve them all."""
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.vfi_png_decode_rgb
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.vfi_crop_flip_normalize
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _raw_size(w: int, h: int, bits: int, interlace: int) -> int:
    """Bytes of the inflated IDAT stream: each pass's scanlines, a filter
    byte and the packed pixels of `bits` bits each."""
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            total += ph * ((pw * bits + 7) // 8 + 1)
    return total


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB: every bit depth (1, 2, 4, 8, 16),
    colour type (0, 2, 3, 4, 6) and Adam7 interlacing, expanded as
    Pillow's `Image.open(...).convert("RGB")` expands them. A file that is
    not a PNG, or one that is malformed, raises ValueError."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file (only PNG frames are taken)")
    off, ihdr, palette, idat = 8, None, b"", []
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"IHDR of {length} bytes")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        off += 12 + length          # length, type, data, CRC
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = ihdr
    chans = CHANNELS.get(color_type)
    if chans is None or interlace not in (0, 1) or not 0 < w * h <= MAX_PX:
        raise ValueError(f"unsupported PNG: {w}x{h}, colour type "
                         f"{color_type}, interlace {interlace}")
    need = _raw_size(w, h, chans * depth, interlace)
    inflate = zlib.decompressobj()
    try:
        # at most one byte past what the header needs: no inflate bomb
        raw = inflate.decompress(b"".join(idat), need + 1)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    out = np.empty((h, w, 3), np.uint8)
    rc = load().vfi_png_decode_rgb(raw, len(raw), w, h, color_type, depth,
                                   interlace, palette, len(palette) // 3,
                                   out.ctypes.data)
    if rc != 0:
        raise ValueError(f"unsupported or malformed PNG (colour type "
                         f"{color_type}, bit depth {depth}, interlace "
                         f"{interlace}, decoder code {rc})")
    return out


def encode_png_rgb(frame: np.ndarray, compress_level: int = 1) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes: 8-bit RGB, not interlaced, every
    scanline filter type 0, the stream deflated by `zlib` at
    `compress_level` (0-9), CRCs from `zlib.crc32`."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"need an (H, W, 3) uint8 frame, got "
                         f"{frame.shape} {frame.dtype}")
    h, w = frame.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = frame.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level))
            + chunk(b"IEND", b""))


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def crop_flip_normalize(img: np.ndarray, top: int, left: int,
                        crop: Tuple[int, int], hflip: bool,
                        imagenet_norm: bool) -> np.ndarray:
    """Crop a (crop_h, crop_w) window at (top, left) out of an (H, W, 3)
    RGB image (cast to uint8 first, as the JAX function does), mirror it
    left to right where `hflip`, scale to [0, 1] and, where
    `imagenet_norm`, ImageNet-normalize it: (crop_h, crop_w, 3) float32,
    bit-equal to `vfi_tpu.native.crop_flip_normalize` built on a host
    with fused multiply-add (`png.cpp` says why). In numpy: s * float32(1
    / 255), or float32(s * float64(float32(1 / 255)) - mean) / std, where
    the float64 sum is exact. A window reaching outside the image raises
    ValueError."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need an (H, W, 3) RGB image, got {img.shape}")
    h, w = img.shape[:2]
    ch, cw = crop
    if not (0 <= top <= h - ch and 0 <= left <= w - cw and ch >= 0
            and cw >= 0):
        raise ValueError(f"crop {ch}x{cw} at ({top}, {left}) reaches "
                         f"outside the {h}x{w} image")
    out = np.empty((ch, cw, 3), np.float32)
    rc = load().vfi_crop_flip_normalize(img.ctypes.data, w, h, top, left,
                                        ch, cw, int(hflip),
                                        int(imagenet_norm), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"crop_flip_normalize refused the window "
                         f"(code {rc})")
    return out


__all__ = ["available", "build", "crop_flip_normalize", "decode_png_rgb",
           "encode_png_rgb", "load"]
