"""Build and bind the port's CUDA kernels.

One `nvcc` process per `vfi_tpu_torch/csrc/*.cu`, all started together,
compiles each for Hopper (`sm_90a`); one more links the objects into a
plain shared library with a C interface, which `ctypes` loads. The library lands in `build/vfi_tpu_torch/<key>/` beside the
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

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "vfi_tpu_torch"
LIB_NAME = "libvfi_tpu_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# An input in two parts (common.cuh InputParts): x0, its image, row and
# pixel strides in elements, c0; x1, its strides, c1 (0: no part 1).
_PARTS = [_P, _L, _L, _L, _I, _P, _L, _L, _L, _I]
# C entry points: name -> argtypes. Every entry returns an int: the
# cudaError_t of its launch (0 = launched), or the count it names.
SIGNATURES = {
    # x, w, bias, out, B, H, W, L, c0..c4, act_mask, th, tw, tg0..tg3,
    # buf_bytes, slot_bytes, smem_bytes (chain_fused_plan), device, stream
    "vfi_conv_chain_bf16": [_P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, bias, out, B, H, W, L, c0..c4, act_mask, th, tw, ck,
    # buf_bytes[0], buf_bytes[1], slot_bytes, smem_bytes
    # (chain_fused_plan, itemsize 4), device, stream
    "vfi_conv_chain_f32": [_P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _P],
    # the input's parts (_PARTS), w, bias, out, B, H, W, Cout, K, act, ck,
    # taps_per_group, x_bytes, smem_bytes (conv2d_plan), device, stream
    "vfi_conv2d_bf16": [*_PARTS, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    # x, w, bias, out, B, H, W, Cin, Cout, K, act, ck, taps_per_group,
    # x_bytes, flush, smem_bytes (conv2d_plan, itemsize 4), device, stream
    "vfi_conv2d_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _P],
    # the input's parts (_PARTS), offset, mask, w, bias, out, out's pixel
    # stride, B, H, W, Cout, R, design, rows, chans, nbuf, xu, x_bytes,
    # smem_bytes (dcn_plan), device, stream
    "vfi_dcn_bounded_bf16": [*_PARTS, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, offset, mask, w, bias, out, B, H, W, Cin, Cout, R, design, rows,
    # chans, xu, x_bytes, smem_bytes (dcn_plan, itemsize 4), device, stream
    "vfi_dcn_bounded_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # image, flow, out, B, H, W, C, out's pixel stride, R, device, stream
    "vfi_warp_bounded_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "vfi_warp_bounded_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
}

_lib = None
_entries: dict = {}
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
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [(p, p.communicate()[0]) for p in procs]
    log = "".join(out for _, out in logs)
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    try:
        failed = [p.returncode for p, _ in logs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
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


def entry(name: str):
    """The C entry point `name` of `SIGNATURES`, bound once: the wrappers
    call it without a lookup on the library. Builds on first use."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(load(), name)
    return fn


def current_stream(index: int) -> int:
    """The raw `cudaStream_t` of PyTorch's current stream on device
    `index`, without building a `torch.cuda.Stream`."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if rc != 0:
        msg = load().vfi_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


if __name__ == "__main__":
    build(verbose=True)
    print(build_info["path"])
