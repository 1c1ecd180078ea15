"""The port's PNG decoder: chunk parsing and inflate in Python (the
standard `zlib` module), scanline unfilter and RGB expansion in C++
(`png.cpp`), bound with ctypes.

The library is compiled from `png.cpp` with the host's C++ compiler on
first use into `build/vfi_tpu_torch/native/<key>/` beside the package (a
git-ignored directory), keyed by a hash of the source and the flags. It
needs no zlib header. A PNG it cannot read raises ValueError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "png.cpp"
BUILD_ROOT = SRC.parents[2] / "build" / "vfi_tpu_torch" / "native"
LIB_NAME = "libvfi_png.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_lib = None


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
    """The loaded library, building it on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.vfi_png_unfilter_rgb
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB. 8-bit non-interlaced gray, RGB,
    palette, gray + alpha and RGBA; anything else raises ValueError."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    off, ihdr, palette, idat = 8, None, b"", []
    while off + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        if kind == b"IHDR":
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
    if depth != 8 or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, interlace "
                         f"{interlace} (8-bit non-interlaced only)")
    raw = zlib.decompress(b"".join(idat))
    out = np.empty((h, w, 3), np.uint8)
    rc = load().vfi_png_unfilter_rgb(raw, len(raw), w, h, color_type,
                                     palette, len(palette) // 3,
                                     out.ctypes.data)
    if rc != 0:
        raise ValueError(f"unsupported or malformed PNG (colour type "
                         f"{color_type}, decoder code {rc})")
    return out


__all__ = ["build", "decode_png_rgb", "load"]
