"""Build and bind the port's CUDA kernels.

One `nvcc` call compiles every `vfi_tpu_torch/csrc/*.cu` for Hopper
(`sm_90a`) into a plain shared library with a C interface, which `ctypes`
loads. The library lands in `build/vfi_tpu_torch/<key>/` beside the
package (a git-ignored directory), keyed by a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here includes PyTorch's headers: a build takes seconds.

Run `python -m vfi_tpu_torch.ops.cuda.build` to build and print the
compiler's register/shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "vfi_tpu_torch"
LIB_NAME = "libvfi_tpu_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Every entry returns the int
# cudaError_t of its launch (0 = launched).
SIGNATURES = {
    # x, w, bias, out, B, H, W, L, c0..c4, act_mask, device, stream
    "vfi_conv_chain_bf16": [_P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _P],
    # x, offset, mask, w, bias, out, B, H, W, Cin, Cout, R, device, stream
    "vfi_dcn_bounded_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    # image, flow, out, B, H, W, C, R, device, stream
    "vfi_warp_bounded_bf16": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
}

_lib = None
build_info: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def _sources() -> list:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the library if its keyed build is missing; return its path."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        build_info.update(path=str(lib), cached=True, seconds=0.0)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, _sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, lib)
    (out_dir / "nvcc.log").write_text(log)
    build_info.update(path=str(lib), cached=False, seconds=secs, log=log)
    if verbose:
        print(log, file=sys.stderr)
    return lib


def load():
    """The loaded library, building it on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vfi_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vfi_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if rc != 0:
        msg = load().vfi_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


if __name__ == "__main__":
    build(verbose=True)
    print(build_info["path"])
