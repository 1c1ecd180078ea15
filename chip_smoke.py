#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vfi_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line with its `seconds`; any failure raises
and the script exits non-zero without a result line:

1. card    the card's name and power limit (nvidia-smi);
2. build   the `nvcc` build of `vfi_tpu_torch/csrc/*.cu` (one process per
           source, in parallel, then one link), and the C++ build of the
           PNG codec (`vfi_tpu_torch/native/png.cpp`);
3. kernels each CUDA kernel at every shape a path below launches (and
           the shapes of the kernels' contracts that none does: the DCN at
           C=67 R=4 and R=8 and C=128 R=4 and R=8, the conv at k=1 and
           k=5, the wide warp at R=4 and at C=67) in bf16, held against
           its plain PyTorch version (max abs error within the stated
           tolerance; the warps bit for bit),
           then timed with CUDA events (`ms`: median of N_TIMED
           synchronised calls after warm-up, the wrapper's host path
           included; `device_ms`: per launch of N_BACK_TO_BACK launches
           queued back to back) beside its plain version, one PyTorch
           library call where one computes the same function (`library_ms`,
           `library_device_ms`), and its bound from bytes and operations
           (`x_bound`: device_ms over it); each DCN row names its design
           ("tile" or "stream") and plan, each warp row its instance
           ("rgb", or "wide16" / "wide2b": the wide kernel's 16-byte or
           2-byte instance), each conv row its tile plan (a one-layer chain
           runs the conv kernel, csrc/conv2d.cu); a chain of 2-4 layers
           has a row for each route (`chain_route` "fused": the chain
           kernel; "layers": one conv-kernel launch a layer) beside the
           route `chain_plan` picks (`plan_route`), and cuDNN layer by
           layer as its library time (a sequence of calls);
4. main    the flagship engine (qocc checkpoint + flow prior, bf16,
           dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
           conv_kernel="pallas") answers three b=1 requests and one b=2
           request at 1280x720 on the card: launch counts (8 conv-chain,
           3 DCN, 1 warp per engine launch), finite outputs in [0, 1], PSNR
           against the same engine run through the plain versions on the
           card, frames/s;
5. serve   (a) the flagship engine with io_uint8 behind the HTTP server
           (`vfi_tpu_torch.serve`, the serve CLI's batcher defaults:
           max_batch 8, 5 ms, 5M px a launch), warmed for 720p pairs and
           5-frame sequences, under a fixed mix from the load generator
           (`tools.bench_serve.run_load`) at 1280x720: 32 raw requests
           from 8 clients, 8 PNG pairs from 4, 4 five-frame sequences
           from 2. Every response 200, 8 / 3 / 1 launches per engine
           launch, every midpoint within PSNR_FLOOR_DB of the same pair
           through the plain-version engine, PNG and raw responses of one
           pair within SERVE_PNG_RAW_LEVELS; per route requests/s,
           midpoints/s, p50 / p99 latency, the batcher's snapshot, and
           the share of the route's wall time the batcher's worker spent
           in launches (stacking, upload, engine, download).
           (b) the serve CLI's own server (`cli.serve.build_server`) at
           the JAX CLI's defaults (exact DCN, unbounded warp): two raw
           requests at 640x480, uint8 midpoints, no kernel launched;
6. video   the flagship engine (float io, as the JAX video path runs it)
           behind `infer.video.interpolate_video`, with a source and a
           sink held in memory (the card's machine has no cv2): VIDEO_FRAMES
           smooth 1280x720 BGR frames of a steady shift at VIDEO_FPS
           (factor 3: two bisection levels of `recursive`), VIDEO_BATCH
           pairs a batch (the engine's 4M-pixel guard runs each as two b=4
           launches). 9 + 8 x 3 frames written in order, each source frame
           bit-equal to its input, each engine output finite, each inserted
           frame within PSNR_FLOOR_DB of the same pipeline through the
           plain-version engine, 8 / 3 / 1 launches per engine launch;
           frames written per second (the pipeline's wall time) and the
           share of it the engine's forwards span on the device. Then one
           reference_compat pass over VIDEO_COMPAT_FRAMES frames: the
           reference CLI's order, duplicates and shift;
7. videos  VIDEOS_CLIPS clips of VIDEOS_FRAMES 1280x720 frames at 30 fps
           (factor 1) through `infer.multi.interpolate_videos` and the
           port's MicroBatcher (VIDEOS_BATCHER): every midpoint within
           PSNR_FLOOR_DB of the plain-version engine, source frames
           bit-equal, launches holding pairs of both clips, 8 / 3 / 1
           launches per engine launch; midpoints/s;
8. infer_cli `cli.infer.main(["two-frame", ...])` with the flagship flags
           on a Middlebury val pair (640x480) decoded by the port, then
           with `--size 360 640`: the written PNG, decoded again, equals
           the engine's own midpoint truncated to uint8 bit for bit, one
           engine launch with 8 / 3 / 1 kernel launches;
9. q12     the 67-channel reference topology (q12: no fuse_proj, R=2)
           with conv_kernel="pallas" on one b=4 batch of Middlebury val
           frames: 8 / 3 / 1 launches, PSNR against its plain-version
           engine (the 67-wide chains and DCN run in the kernels);
           then `q12_r8`: the same batch at dcn_max_offset=8 (a radius
           the JAX engine takes too), whose three DCNs run the stream
           design, counted by shape, against its plain-version engine;
10. eval   the Middlebury eval entry point (`vfi_tpu_torch.cli.eval.sweep`)
           over data/processed/val at batch 4, bf16, conv_kernel="xla"
           and use_pallas, as the JAX package's records were made: qocc
           native, qocc with auto_scale 9.0 + TTA, and q12. Each mean PSNR
           within 0.05 dB and mean SSIM within 0.002 of its record
           (`artifacts/*_eval.json`), 3 DCN and 1 warp launches per model
           forward and no chain launch; per-scene rows, the auto_scale
           probes, seconds and pairs/s;
11. conv_compare conv_kernel "xla" against "pallas", taking turns, on the
           flagship's b=1 720p requests and on the three eval sweeps:
           seconds, which is faster, launches per forward, and each
           sweep's quality under "pallas" against its record;
12. tools  the kernel tools in-process (`vfi_tpu_torch.tools`,
           `TOOL_RUNS`): bench_conv over its four shapes at 720p,
           bench_kernels' DCN at vga (C=67, R=2) and its warp (C=3 and
           C=64): each kernel within tolerance of its plain version, and
           the conv, DCN and warp kernels launched;
13. grad   gradients through each kernel wrapper (conv, chain of three
           layers and of one, DCN on the tile and the stream design, warp
           at C=3 and C=64) against those
           through its plain version at a small shape (GRAD_SHAPE,
           tolerance stated there);
14. profile (only with --profile) torch.profiler over one b=1 request: the
           device's busy share of the request's wall time and device time
           by kernel, split into the port's CUDA kernels and the rest.

Each kernel row's `launches` is its count over the paths (main, serve,
video, videos, infer_cli, q12, eval, tools) that launch its shape; the run fails when a path launches a
(kernel, shape) that no row checks.

The lines before the last are the `kernels` JSON line and the card's
`nvidia-smi --query-gpu=name,power.limit` line; the last line is
`{"ok": true, "device": {...}}`. Imports only torch, numpy and the port.
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

import vfi_tpu_torch
from vfi_tpu_torch import native
from vfi_tpu_torch.cli import infer as infer_cli
from vfi_tpu_torch.cli import serve as serve_cli
from vfi_tpu_torch.cli.eval import sweep
from vfi_tpu_torch.data import load_image
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.infer.multi import interpolate_videos
from vfi_tpu_torch.infer.video import interpolate_video
from vfi_tpu_torch.infer.video_io import (CAP_PROP_FPS, CAP_PROP_FRAME_COUNT,
                                          CAP_PROP_FRAME_HEIGHT,
                                          CAP_PROP_FRAME_WIDTH, to_float,
                                          to_u8)
from vfi_tpu_torch.ops.cuda import (WRAPPERS, bounded_warp,
                                    bounded_warp_plain, build, chain_plan,
                                    conv2d,
                                    conv2d_plain, conv2d_plan, conv_chain,
                                    conv_chain_plain, dcn_plan,
                                    deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain,
                                    launch_counts, pack_conv2d,
                                    pack_conv_chain, pack_dcn,
                                    reset_launch_counts)
from vfi_tpu_torch.ops.cuda.conv import ROUTES
from vfi_tpu_torch.serve import (BatcherStats, InterpolationServer,
                                 encode_pair_body, encode_raw_body,
                                 encode_seq_body)
from vfi_tpu_torch.tools import bench_conv, bench_kernels
from vfi_tpu_torch.tools.bench_serve import run_load
from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(vfi_tpu_torch.__file__)))
CKPT = os.path.join(ROOT, "artifacts", "emavfi_qocc_best")
Q12 = os.path.join(ROOT, "artifacts", "emavfi_q12_best")
VAL = os.path.join(ROOT, "data", "processed", "val")
H, W = 720, 1280
# Middlebury val frames and the eval batch.
EH, EW, EB = 480, 640, 4
SEED = 0
N_TIMED = 20
# Back-to-back launches a row's device time averages over.
N_BACK_TO_BACK = 100
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# float32 FLOP/s outside the tensor cores. They assume the 700 W limit.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# Kernel vs plain version, both bf16 with float32 accumulation: they differ
# only in summation order, which can move a bf16 rounding by one ulp (and
# a flipped intermediate of a chain nudges the next layer). Tolerance: two
# bf16 ulps at the top of the output's range, 2**-7 * max|plain|.
REL_TOL = 2.0 ** -7
# Engine vs the same engine through the plain versions: bf16 end to end, so
# rounding-order differences compound through ~20 layers and the flow; a
# wrong tap, channel or boundary costs far more than this floor allows.
PSNR_FLOOR_DB = 40.0
FLAGSHIP = dict(bf16=True, dcn_max_offset=1, warp_max_flow=16,
                cascade_levels=2, conv_kernel="pallas")
Q12_ENGINE = dict(bf16=True, dcn_max_offset=2, warp_max_flow=16,
                  cascade_levels=2)
# The q12_r8 request's DCN radius: q12's weights at a radius past the tile
# design's (the stream design's path; the checkpoint was trained at R=2,
# so its quality there is no record).
Q12_R8 = 8
# The eval records' route (`eval.py --use_pallas`: the v4 DCN, the bounded
# warp, the conv trunk on plain XLA convs, the JAX CLI's only setting);
# flow prior, warp bound 16, cascade 2 (tools/queueAF.sh:33-40,
# tools/queueT.sh:114-117). Here the DCN and warp kernels always run.
EVAL_ENGINE = dict(bf16=True, warp_max_flow=16, cascade_levels=2,
                   conv_kernel="xla")
SWEEPS = (
    ("qocc", CKPT, dict(dcn_max_offset=1), "qocc_eval.json"),
    ("qocc_as9_tta", CKPT, dict(dcn_max_offset=1, auto_scale=9.0, tta=True),
     "qocc_autoscale_tta_eval.json"),
    ("q12", Q12, dict(dcn_max_offset=2), "q12_eval.json"),
)
# Quality against the JAX package's records on the TPU: bf16 on both, so
# rounding-order differences move a scene's PSNR by hundredths of a dB;
# a wrong tap, channel or route moves the mean by tenths or more.
PSNR_TOL_DB = 0.05
SSIM_TOL = 0.002
# Launches of each wrapper per engine launch on the flagship path. The
# conv2d wrapper runs only in the kernel tools; the three one-layer offset
# chains run the conv kernel (csrc/conv2d.cu) and count as conv_chain.
PER_LAUNCH = {"conv_chain": 8, "deform_conv2d_bounded": 3, "bounded_warp": 1,
              "conv2d": 0}
CHAIN_TPU = "vfi_tpu/ops/pallas/conv.py:543"
CONV_TPU = "vfi_tpu/ops/pallas/conv.py:92"
CONV_V2_TPU = "vfi_tpu/ops/pallas/conv.py:282"
DCN_TPU = "vfi_tpu/ops/pallas/sampling.py:1027"
DCN_V4_TPU = "vfi_tpu/ops/pallas/sampling.py:379"
DCN_V3_TPU = "vfi_tpu/ops/pallas/sampling.py:135"
WARP_TPU = "vfi_tpu/ops/pallas/sampling.py:739"
WARP_V1_TPU = "vfi_tpu/ops/pallas/sampling.py:883"
# The serve phase: the serve CLI's batcher defaults; per route (wire
# route, clients, requests); midpoints a sequence request asks for. A PNG
# response and a raw one of the same pair go through one engine in other
# batches: they may differ where bf16 rounding moves a midpoint across a
# level, by a level or two, no more.
SERVE_BATCHER = dict(max_batch=8, max_delay_ms=5.0,
                     max_px_per_launch=5_000_000)
SERVE_MIX = (("raw", 8, 32), ("png", 4, 8), ("seq", 2, 4))
SERVE_SEQ = 4
SERVE_PNG_RAW_LEVELS = 2
# The serve CLI's own server: frame size and requests.
CLI_H, CLI_W, CLI_REQUESTS = 480, 640, 2
# The video phase: source frames, their rate (pick_interpolation_factor:
# 3, two bisection levels), pairs a batch; frames of the reference_compat
# pass.
VIDEO_FRAMES, VIDEO_FPS, VIDEO_BATCH = 9, 15.0, 8
VIDEO_COMPAT_FRAMES = 3
# The videos phase: clips, frames a clip, their rate (factor 1), and the
# shared batcher (launch size, wait for batch-mates), as the JAX CLI's
# defaults.
VIDEOS_CLIPS, VIDEOS_FRAMES, VIDEOS_FPS = 2, 5, 30.0
VIDEOS_BATCHER = dict(batch_pairs=8, max_delay_ms=50.0)
# The infer_cli phase: the flagship's flags, the val pair, the resize.
INFER_FLAGS = ["--dcn_max_offset", "1", "--warp_max_flow", "16",
               "--cascade_levels", "2", "--flow_prior", "--conv_kernel",
               "pallas"]
INFER_PAIR = ("Urban", "frame10.png", "frame11.png")
INFER_SIZE = (360, 640)
# The kernel tools' runs in the tools phase: few iterations each.
TOOL_RUNS = (
    (bench_conv, ["--shapes", "all", "--kernels", "xla,im2col,direct,v2,plain",
                  "--iters", "3"]),
    (bench_kernels, ["--size", "vga", "--kernels", "xla,pallas,v4,v5",
                     "--iters", "3"]),
    (bench_kernels, ["--warp", "--iters", "3"]),
)
# Library calls the tools time beside the kernels (not checked).
TOOL_LIBRARY = ("xla", "xla-shifts", "plain", "grid_sample")
# Gradients through a kernel wrapper against those through its plain
# version. The DCN, warp and chain backward is autograd of the plain
# version itself, so their gradients differ only where the inputs'
# atomics add in another order; the conv's is closed-form float32 with the
# ReLU mask read off the kernel's bf16 output, which can flip where the
# kernel and the plain version round a value near 0 apart. Tolerance: as
# the forward, 2**-7 * max|plain gradient|.
GRAD_SHAPE = (2, 24, 40)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def median_ms(fn, n: int = N_TIMED, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, n: int = N_BACK_TO_BACK, warmup: int = 3) -> float:
    """Device time per launch of `n` back-to-back launches between two
    events, as tools/conv_turns.py times them: the launches are queued
    behind a spin of the card (`torch.cuda._sleep`), so the host's launch
    path does not pace a launch shorter than itself; the spin doubles
    until every launch was queued before the first event ran. A call of
    many kernels (a sequence of library calls) can fill the card's launch
    queue, which then blocks the host until the spin ends: past a spin of
    2^26 cycles the launch count halves instead."""
    for _ in range(warmup):
        fn()
    spin = 1 << 22
    while True:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued_first = not a.query()
        b.synchronize()
        if queued_first or n == 1:
            return a.elapsed_time(b) / n
        if spin < 1 << 26:
            spin *= 2
        else:
            n //= 2


def bound(nbytes: float, flops_bf16: float, flops_f32: float = 0.0):
    """Least time in ms: the largest of the bytes over the memory rate and
    each type's operations over its own peak (the tensor cores and the
    float32 units run at once)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops_bf16 / PEAK_BF16, flops_f32 / PEAK_F32)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                exact: bool = False) -> dict:
    """Max abs error of `got` against `ref`, within REL_TOL * max|ref| (0
    where `exact`)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - ref.float()).abs().max().item()
    tol = 0.0 if exact else REL_TOL * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > tol {tol}")
    return {"max_abs_err": err, "tol": tol}


def smooth_frames(gen: np.random.Generator, b: int) -> tuple:
    """A smooth random texture (sum of random sinusoids) and a copy
    shifted by a few pixels, float32 [0, 1], (b, H, W, 3)."""
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    frames = np.zeros((b, H, W, 3), np.float32)
    for i in range(b):
        for c in range(3):
            acc = np.zeros((H, W), np.float32)
            for _ in range(8):
                fy, fx = gen.uniform(0.005, 0.06, 2) * gen.choice([-1, 1], 2)
                acc += np.sin(fy * yy + fx * xx + gen.uniform(0, 2 * np.pi))
            frames[i, ..., c] = 0.5 + 0.06 * acc
    frames = np.clip(frames, 0.0, 1.0)
    shifted = np.roll(frames, shift=(3, 6), axis=(1, 2))
    return frames, shifted


def phase_build() -> dict:
    t0 = time.perf_counter()
    build.load()
    info = dict(build.build_info)
    ptxas = [ln.strip() for ln in info.pop("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    t1 = time.perf_counter()
    native.load()               # the PNG codec, before any route is timed
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "nvcc_seconds": info["seconds"], "cached": info["cached"],
            "png_codec_seconds": time.perf_counter() - t1, "ptxas": ptxas}


def row_name(base: str, b: int, h: int, w: int) -> str:
    """`base@HxW` for a b=1 shape (the flagship rows' names, kept stable
    so runs compare), else `base@BxHxW`."""
    return f"{base}@{h}x{w}" if b == 1 else f"{base}@{b}x{h}x{w}"


def kernel_row(name, source, replaces, key, kernel, plain, library,
               io_bytes, flops_bf16, flops_f32=0.0, ref=None, plain_ms=None,
               exact=False, **extra) -> dict:
    """Check one kernel call against its plain version, then time the
    kernel, the plain version and (where one exists) a library call.
    `key` = (paths, wrapper name, launch shape): the paths whose runs
    launch the wrapper at this shape (their counts are this row's
    launches), or () for a shape no path of this run takes. `ref` and
    `plain_ms`, where given, are the plain version's result and time on
    these inputs, shared by two rows; `exact`: the kernel must equal its
    plain version bit for bit. `extra` fields go into the row as they
    are."""
    got = kernel()
    if ref is None:
        ref = plain()
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, **extra,
           **check_close(name, got, ref, exact)}
    row["ms"] = median_ms(kernel)
    row["device_ms"] = device_ms(kernel)
    row["plain_ms"] = median_ms(plain) if plain_ms is None else plain_ms
    row["library_ms"] = None if library is None else median_ms(library)
    row["library_device_ms"] = (None if library is None
                                else device_ms(library))
    row["bound_ms"], row["bound_by"] = bound(io_bytes + nbytes(got),
                                             flops_bf16, flops_f32)
    row["x_bound"] = row["device_ms"] / row["bound_ms"]
    emit({"phase": "kernel", **row})
    row["_key"] = key
    return row


def chain_rows(rnd, sd, tag, cin, names, acts, b, h, w, paths) -> list:
    """The chain at one shape with the checkpoint's weights, packed once as
    the engine does: one row a route ("fused", the chain kernel; "layers",
    one conv-kernel launch a layer; a chain of one layer has only the
    latter), both checked against one plain result. `plan_route` names
    the route `chain_plan` picks; the paths' launches count on that
    route's row (the other's key has no path). Library: cuDNN layer by
    layer (`F.conv2d` in bf16, then `relu` where the layer has one), the
    "xla" route's trunk: a sequence of calls where the chain has more than
    one layer."""
    ws = [sd[f"{n}.weight"].cuda() for n in names]
    bs = [sd[f"{n}.bias"].cuda() for n in names]
    acts = tuple(bool(a) for a in acts)
    x = rnd(b, h, w, cin)
    wb = [t.to(torch.bfloat16) for t in ws + bs]

    def library():
        y = x.permute(0, 3, 1, 2)
        for wt, bt, a in zip(wb[:len(ws)], wb[len(ws):], acts):
            y = F.conv2d(y, wt, bt, padding=1)
            y = torch.relu(y) if a else y
        return y

    chans = tuple([cin] + [wt.shape[0] for wt in ws])
    pk = pack_conv_chain(ws, bs)
    plan = chain_plan(chans, acts, b, h, w, torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin)
    plain = lambda: conv_chain_plain(x, ws, bs, acts)  # noqa: E731
    ref, plain_ms = plain(), median_ms(plain)
    calls = " -> ".join(f"F.conv2d{'+relu' if a else ''}" for a in acts)
    rows = []
    for route in ROUTES if len(ws) > 1 else ("layers",):
        suffix = "/layers" if len(ws) > 1 and route == "layers" else ""
        rows.append(kernel_row(
            row_name(f"conv_chain/{tag}{suffix}", b, h, w),
            "vfi_tpu_torch/csrc/"
            + ("conv_chain.cu" if route == "fused" else "conv2d.cu"),
            CHAIN_TPU, (paths if route == plan["route"] else (),
                        "conv_chain", (route, chans, h, w)),
            lambda: conv_chain(x, ws, bs, acts, packed=pk, route=route),
            plain, library, nbytes(x) + nbytes(*ws) // 2 + nbytes(*bs),
            sum(2.0 * b * h * w * 9 * wt.shape[1] * wt.shape[0]
                for wt in ws),
            ref=ref, plain_ms=plain_ms, chain_route=route,
            plan_route=plan["route"], library_call=calls,
            plan=plan["fused"] if route == "fused" else plan["layers"]))
    return rows


def conv2d_row(rnd, gen, cin, cout, k, b, h, w, variant, replaces,
               paths, act=True) -> dict:
    """The single conv at one shape, random weights (no checkpoint holds
    these convs); library: F.conv2d in bf16 with the bias, then the ReLU
    where the row fuses it (two calls)."""
    dev = gen.device
    x = rnd(b, h, w, cin)
    wt = torch.randn(cout, cin, k, k, generator=gen, device=dev) / (
        k * k * cin) ** 0.5
    bt = torch.randn(cout, generator=gen, device=dev) * 0.1
    xn, wb, bb = x.permute(0, 3, 1, 2), wt.to(torch.bfloat16), bt.to(
        torch.bfloat16)

    def library():
        y = F.conv2d(xn, wb, bb, padding=k // 2)
        return torch.relu(y) if act else y

    pk = pack_conv2d(wt, bt)
    tag = f"conv2d{'/v2' if variant == 'v2' else ''}/{cin}x{cout}k{k}"
    return kernel_row(
        row_name(tag, b, h, w), "vfi_tpu_torch/csrc/conv2d.cu", replaces,
        (paths, "conv2d", (cin, cout, k, h, w)),
        lambda: conv2d(x, wt, bt, act, variant, packed=pk),
        lambda: conv2d_plain(x, wt, bt, act), library,
        nbytes(x) + nbytes(wt) // 2 + nbytes(bt),
        2.0 * b * h * w * k * k * cin * cout,
        library_call="F.conv2d+relu" if act else "F.conv2d",
        plan=conv2d_plan(cin, cout, k))


def dcn_row(rnd, wt, bt, b, h, w, R, replaces, paths) -> dict:
    """Bounded DCN at a fusion stack's shape with weights `wt`, `bt`;
    offsets reach past R so the clamp is exercised. No single PyTorch call
    computes it (torchvision is absent), so no library time. The row names
    the plan the launch runs: its design ("tile", the weight-stationary
    GEMM, or "stream", the same core with the weights streamed, where no
    tile plan fits) and tiles."""
    c = wt.shape[1]
    x = rnd(b, h, w, c)
    off = rnd(b, h, w, 18, scale=0.8 * R)
    mask = torch.sigmoid(rnd(b, h, w, 9, scale=2.0).float()).to(
        torch.bfloat16)
    pk = pack_dcn(wt, bt)
    n = b * h * w
    plan = dcn_plan(c, wt.shape[0], R, torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin)
    return kernel_row(
        row_name("deform_conv2d_bounded" if b == 1 and c == 64 and R == 1
                 else f"deform_conv2d_bounded/C{c}R{R}", b, h, w),
        "vfi_tpu_torch/csrc/dcn_bounded.cu", replaces,
        (paths, "deform_conv2d_bounded", (c, wt.shape[0], h, w, R)),
        lambda: deform_conv2d_bounded(x, off, mask, wt, bt, R, packed=pk),
        lambda: deform_conv2d_bounded_plain(x, off, mask, wt, bt, R), None,
        nbytes(x, off, mask) + nbytes(wt) // 2 + nbytes(bt),
        2.0 * n * 9 * c * wt.shape[0], 8.0 * n * 9 * c,
        design=plan["design"], plan=plan)


def warp_row(rnd, b, h, w, paths, dev, c=3, R=16, replaces=WARP_TPU) -> dict:
    img = rnd(b, h, w, c)
    flow = rnd(b, h, w, 2, scale=10.0 * R / 16)
    fc = flow.float().clamp(-R, R)
    gx = (torch.arange(w, device=dev).float() + fc[..., 0]) * (2 / (w - 1)) - 1
    gy = (torch.arange(h, device=dev).float()[:, None] + fc[..., 1]) * (
        2 / (h - 1)) - 1
    grid = torch.stack([gx, gy], dim=-1).to(torch.bfloat16)
    imn = img.permute(0, 3, 1, 2)
    return kernel_row(
        row_name("bounded_warp" if c == 3 else f"bounded_warp/C{c}R{R}",
                 b, h, w),
        "vfi_tpu_torch/csrc/warp_bounded.cu", replaces,
        (paths, "bounded_warp", (c, h, w, R)),
        lambda: bounded_warp(img, flow, R),
        lambda: bounded_warp_plain(img, flow, R),
        lambda: F.grid_sample(imn, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=True),
        nbytes(img, flow), 0.0, (16.0 + 8.0 * c) * b * h * w, exact=True,
        design=warp_instance(img))


def warp_instance(img: torch.Tensor) -> str:
    """The instance of csrc/warp_bounded.cu a warp of `img` runs (the C
    entry picks it by the same test; the output is a fresh, aligned
    tensor)."""
    if img.shape[-1] <= 4:
        return "rgb"
    aligned = img.shape[-1] % 8 == 0 and img.data_ptr() % 16 == 0
    return "wide16" if aligned else "wide2b"


def phase_kernels(sd: dict, sd12: dict, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    rows = []
    chains = [
        ("feat", 64, [f"feat_ext_block{i}.conv" for i in range(3)],
         (1, 1, 1)),
        ("motion", 128, [f"motion_conv{i}.conv" for i in (1, 2, 3)],
         (1, 1, 0)),
        ("offset", 64, ["fusion_dcn0.offset_conv"], (0,)),
        ("rec", 64, [f"rec_conv{i}.conv" for i in (1, 2, 3)], (1, 1, 0)),
    ]
    # The serve, video and videos phases' engine is the flagship at 720p:
    # the same shapes (the launch keys hold no batch size). The infer_cli
    # phase runs the flagship on a 480x640 val pair and at 360x640, whose
    # cascade level is the 720p request's.
    main, q12, ev = ("main", "serve", "video", "videos"), ("q12",), ("eval",)
    cli = ("infer_cli",)
    q12s = q12 + ("q12_r8",)    # both q12 requests' chains and warp
    for h, w, chain in [(H, W, c) for c in chains]:
        rows += chain_rows(rnd, sd, *chain, 1, h, w, main)
    for chain in chains[:2]:
        rows += chain_rows(rnd, sd, *chain, 1, H // 2, W // 2, main + cli)
    # The infer_cli phase's other shapes: the offset and reconstruction
    # chains at both sizes, the trunk chains at 360x640's cascade level.
    ih, iw = INFER_SIZE
    for h, w in ((EH, EW), (ih, iw)):
        for chain in (chains[2], chains[3]):
            rows += chain_rows(rnd, sd, *chain, 1, h, w, cli)
    for chain in chains[:2]:
        rows += chain_rows(rnd, sd, *chain, 1, ih // 2, iw // 2, cli)
    # The q12 phase's chains on its batch of val frames: the 64-wide trunk
    # chains at native and cascade resolution (infer_cli's val pair's
    # too), and the reference topology's 67-wide offset and reconstruction
    # chains.
    for h, w in ((EH, EW), (EH // 2, EW // 2)):
        for chain in chains[:2]:
            rows += chain_rows(rnd, sd12, *chain, EB, h, w, q12s + cli)
    rows += chain_rows(rnd, sd12, "offset67", 67,
                       ["fusion_dcn0.offset_conv"], (0,), EB, EH, EW, q12s)
    rows += chain_rows(rnd, sd12, "rec67", 67,
                       [f"rec_conv{i}.conv" for i in (1, 2, 3)],
                       (1, 1, 0), EB, EH, EW, q12s)

    dcn, dcn12 = [(d["fusion_dcn0.weight"].cuda(), d["fusion_dcn0.bias"].cuda())
                  for d in (sd, sd12)]
    rows.append(dcn_row(rnd, *dcn, 1, H, W, 1, DCN_TPU, main))
    rows.append(dcn_row(rnd, *dcn, 1, ih, iw, 1, DCN_TPU, cli))
    # The v4 route's shapes on the eval path: qocc (C=64, R=1) at native
    # (infer_cli's val pair's too) and auto_scale's half resolution, q12
    # (C=67, R=2, also the q12 phase's); C=67 at R=4 (the training
    # config's radius), which no path of this run takes; and at R=8, the
    # q12_r8 request's (stream design).
    rows.append(dcn_row(rnd, *dcn, EB, EH, EW, 1, DCN_V4_TPU, ev + cli))
    rows.append(dcn_row(rnd, *dcn, EB, EH // 2, EW // 2, 1, DCN_V4_TPU, ev))
    rows.append(dcn_row(rnd, *dcn12, EB, EH, EW, 2, DCN_V4_TPU, q12 + ev))
    rows.append(dcn_row(rnd, *dcn12, EB, EH, EW, 4, DCN_V4_TPU, ()))
    rows.append(dcn_row(rnd, *dcn12, EB, EH, EW, Q12_R8, DCN_V4_TPU,
                        ("q12_r8",)))

    # Bounded warp of the RGB frame; flows reach past R = 16. The library
    # call is grid_sample on the clamped flow's normalized grid.
    for b, h, w, paths in ((1, H, W, main), (EB, EH, EW, q12s + ev + cli),
                           (EB, EH // 2, EW // 2, ev), (1, ih, iw, cli)):
        rows.append(warp_row(rnd, b, h, w, paths, dev))
    return rows + tool_rows(rnd, gen, dcn12, dev)


def tool_rows(rnd, gen, dcn12, dev) -> list:
    """The kernels the tools phase launches, at the tools' shapes (key
    paths ("tools",)), and the shapes of the contracts this slice added
    that no path takes (key paths ()): the conv at k = 1 and 5, the DCN at
    radii that need smaller tiles or channel chunks, the wide warp at
    R = 4 and, on its 2-byte instance, at C = 67."""
    tools = ("tools",)
    rows = [conv2d_row(rnd, gen, cin, cout, 3, 1, H, W, "im2col", CONV_TPU,
                       tools) for cin, cout in bench_conv.ALL_SHAPES]
    rows += [conv2d_row(rnd, gen, cin, 64, 3, 1, H, W, "v2", CONV_V2_TPU,
                        tools) for cin in (64, 128)]
    rows.append(conv2d_row(rnd, gen, 64, 32, 1, 1, EH, EW, "im2col",
                           CONV_TPU, (), act=False))
    rows.append(conv2d_row(rnd, gen, 64, 64, 5, 1, EH, EW, "im2col",
                           CONV_TPU, ()))
    # bench_kernels' defaults (vga, C=67, R=2) with q12's weights, then
    # C=67 R=8 and C=128 at R=4 and 8 with random ones.
    eh, ew = bench_kernels.SIZES["vga"]
    rows.append(dcn_row(rnd, *dcn12, 1, eh, ew, 2, DCN_V3_TPU, tools))
    rows.append(dcn_row(rnd, *dcn12, 1, eh, ew, 8, DCN_V3_TPU, ()))
    w128 = torch.randn(128, 128, 3, 3, generator=gen, device=dev) / 34.0
    b128 = torch.randn(128, generator=gen, device=dev) * 0.1
    for R in (4, 8):
        rows.append(dcn_row(rnd, w128, b128, 1, eh, ew, R, DCN_V3_TPU, ()))
    for c, R, paths in ((3, bench_kernels.WARP_R, tools),
                        (64, bench_kernels.WARP_R, tools), (64, 4, ()),
                        (67, bench_kernels.WARP_R, ())):
        rows.append(warp_row(rnd, 1, eh, ew, paths, dev, c, R,
                             WARP_TPU if c == 3 else WARP_V1_TPU))
    return rows


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = (a.float() - b.float()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def phase_main(params, flow_params) -> dict:
    gen = np.random.default_rng(SEED)
    f0, f1 = smooth_frames(gen, 2)
    requests = [(f0[:1], f1[:1]), (f1[:1], f0[:1]), (f0[1:], f1[1:]),
                (f0, f1)]
    eng = FrameInterpolator(params, flow_params=flow_params, device="cuda",
                            **FLAGSHIP)
    for a, b in requests[-2:]:             # warm-up: allocator, cuDNN plans,
        eng.midpoints(a, b)                # for both request shapes
    torch.cuda.synchronize()

    reset_launch_counts()
    outs, times = [], []
    for a, b in requests:
        t0 = time.perf_counter()
        out = eng.midpoints(a, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    counts = launch_counts()
    by_shape = shapes_now()

    n_launch = len(requests)
    for k, per in PER_LAUNCH.items():
        if counts[k] != per * n_launch:
            raise AssertionError(f"{k}: {counts[k]} launches over {n_launch} "
                                 f"engine launches, expected {per} each")
    for (a, _), out in zip(requests, outs):
        if tuple(out.shape) != a.shape:
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite output")
        if out.min().item() < 0.0 or out.max().item() > 1.0:
            raise AssertionError("output outside [0, 1]")

    plain = FrameInterpolator(params, flow_params=flow_params,
                              device="cuda", use_kernels=False, **FLAGSHIP)
    psnrs = [psnr(out, plain.midpoints(a, b))
             for (a, b), out in zip(requests, outs)]
    if not min(psnrs) >= PSNR_FLOOR_DB:
        raise AssertionError(f"PSNR vs plain engine {psnrs} below "
                             f"{PSNR_FLOOR_DB} dB")
    pairs = sum(a.shape[0] for a, _ in requests)
    return {"phase": "main", "requests": [a.shape[0] for a, _ in requests],
            "request_seconds": times, "launches": counts,
            "frames_per_s_b1": 1.0 / float(np.median(times[:3])),
            "frames_per_s_b2": 2.0 / times[3],
            "pairs": pairs, "psnr_vs_plain_db": psnrs,
            "psnr_floor_db": PSNR_FLOOR_DB, "_by_shape": by_shape,
            "_engine": eng, "_request": requests[0]}


def u8(frames: np.ndarray) -> np.ndarray:
    """float32 [0, 1] -> uint8 as the server rounds: x * 255 + 0.5."""
    return np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean(((a.astype(np.float64) - b.astype(np.float64)) / 255.0)
                  ** 2)
    return float("inf") if mse == 0 else float(10.0 * np.log10(1.0 / mse))


def phase_serve(params, flow_params) -> dict:
    """(a) The flagship engine (io_uint8) behind the HTTP server under
    SERVE_MIX; (b) the serve CLI's own server at its defaults. Emits a
    line per route and returns the phase's summary."""
    t0 = time.perf_counter()
    f0, f1 = smooth_frames(np.random.default_rng(SEED), 2)
    a, b = u8(f0), u8(f1)
    pairs = [(a[0], b[0]), (b[0], a[0]), (a[1], b[1]), (b[1], a[1])]
    # Five consecutive frames of a steady motion, from each texture.
    seqs = [np.stack([np.roll(a[i], (3 * k, 6 * k), axis=(0, 1))
                      for k in range(SERVE_SEQ + 1)]) for i in range(2)]
    bodies = {"raw": [encode_raw_body(x, y) for x, y in pairs],
              "png": [encode_pair_body(native.encode_png_rgb(x),
                                       native.encode_png_rgb(y))
                      for x, y in pairs],
              "seq": [encode_seq_body(fr) for fr in seqs]}

    eng = FrameInterpolator(params, flow_params=flow_params, device="cuda",
                            io_uint8=True, **FLAGSHIP)
    forwards = [0]
    forward = eng._forward

    def counted(x, y):          # engine launches: one model forward each
        forwards[0] += 1
        return forward(x, y)

    eng._forward = counted
    server = InterpolationServer(eng, port=0, **SERVE_BATCHER)
    busy = [0.0]                # the batcher worker's seconds in launches
    for name in ("_launch", "_launch_seq"):
        def timed(*args, _launch=getattr(server.batcher, name)):
            t = time.perf_counter()
            try:
                return _launch(*args)
            finally:
                busy[0] += time.perf_counter() - t
        setattr(server.batcher, name, timed)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    routes, by_shape = [], {fn.__name__: Counter() for fn in WRAPPERS}
    try:
        t1 = time.perf_counter()
        server.warmup([(H, W), (SERVE_SEQ + 1, H, W)])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        for route, clients, total in SERVE_MIX:
            server.batcher.stats = BatcherStats()
            forwards[0], busy[0] = 0, 0.0
            reset_launch_counts()
            res = run_load(url, bodies[route], clients, total, 120.0,
                           raw=route == "raw",
                           seq=SERVE_SEQ if route == "seq" else 0, keep=True)
            counts = launch_counts()
            for fn, c in shapes_now().items():
                by_shape[fn].update(c)
            res.update(route=route, requests=total,
                       engine_launches=forwards[0], launches=counts,
                       worker_busy_s=busy[0],
                       worker_busy_share=busy[0] / res["wall_s"])
            routes.append(res)
    finally:
        server.shutdown()

    plain = FrameInterpolator(params, flow_params=flow_params, device="cuda",
                              io_uint8=True, use_kernels=False, **FLAGSHIP)
    ref_pairs = plain.midpoints(np.stack([x for x, _ in pairs]),
                                np.stack([y for _, y in pairs])).cpu().numpy()
    ref_seqs = [plain.midpoints_sequence(fr).cpu().numpy() for fr in seqs]

    failures = []
    for res in routes:
        route, responses = res["route"], res.pop("responses")
        bad = [(st, data) for st, data in responses if st != 200]
        if bad or res["errors"]:
            failures.append(f"{route}: statuses "
                            f"{sorted({st for st, _ in bad})}, the first "
                            f"answer {bad[0][1][:300]!r}")
            continue
        for k, v in res["launches"].items():
            if v != PER_LAUNCH[k] * res["engine_launches"]:
                failures.append(f"{route}: {k} {v} launches over "
                                f"{res['engine_launches']} engine launches")
        outs, psnrs = [], []
        for i, (_, data) in enumerate(responses):
            if route == "seq":
                got = np.frombuffer(data, np.uint8).reshape(SERVE_SEQ, H, W, 3)
                psnrs += [psnr_u8(g, r) for g, r in
                          zip(got, ref_seqs[i % len(seqs)])]
            else:
                got = (native.decode_png_rgb(data) if route == "png" else
                       np.frombuffer(data, np.uint8).reshape(H, W, 3))
                psnrs.append(psnr_u8(got, ref_pairs[i % len(pairs)]))
            outs.append(got)
        res["psnr_vs_plain_db_min"] = min(psnrs)
        res["midpoints_checked"] = len(psnrs)
        if not min(psnrs) >= PSNR_FLOOR_DB:
            failures.append(f"{route}: PSNR vs plain engine {min(psnrs)} "
                            f"below {PSNR_FLOOR_DB} dB")
        res["_outs"] = outs
    by_route = {r["route"]: r for r in routes}
    png_raw = None
    if "_outs" in by_route["png"] and "_outs" in by_route["raw"]:
        png_raw = max(int(np.abs(p.astype(np.int16) - r.astype(np.int16))
                          .max()) for p, r in zip(by_route["png"]["_outs"],
                                                  by_route["raw"]["_outs"]))
        if png_raw > SERVE_PNG_RAW_LEVELS:
            failures.append(f"PNG vs raw responses differ by {png_raw} "
                            f"levels, more than {SERVE_PNG_RAW_LEVELS}")
    for res in routes:
        res.pop("_outs", None)
        emit({"phase": "serve_route", **res})

    cli = phase_serve_cli()
    emit(cli)
    if cli["failures"]:
        failures += cli["failures"]
    if failures:
        raise AssertionError("serve: " + "; ".join(failures))
    return {"phase": "serve", "seconds": time.perf_counter() - t0,
            "warmup_seconds": warm_s, "batcher": SERVE_BATCHER,
            "png_vs_raw_max_levels": png_raw,
            "routes": {r["route"]: {k: r[k] for k in (
                "requests_per_s", "midpoints_per_s", "latency_ms_p50",
                "latency_ms_p99", "engine_launches", "worker_busy_share",
                "wall_s")}
                for r in routes},
            "_by_shape": by_shape}


def phase_serve_cli() -> dict:
    """The serve CLI's own server at the JAX CLI's defaults (exact DCN,
    unbounded warp, io_uint8, no kernel): CLI_REQUESTS raw requests at
    CLI_H x CLI_W, answered 200 with uint8 midpoints of that shape, and
    no kernel launched."""
    t0 = time.perf_counter()
    server = serve_cli.build_server(["--model_path", CKPT + ".npz",
                                     "--flow_prior", "--port", "0"]).start()
    gen = np.random.default_rng(SEED + 2)
    body = encode_raw_body(*(gen.integers(0, 256, (CLI_H, CLI_W, 3))
                             .astype(np.uint8) for _ in range(2)))
    try:
        reset_launch_counts()
        res = run_load(f"http://127.0.0.1:{server.port}", body, CLI_REQUESTS,
                       CLI_REQUESTS, 300.0, raw=True, keep=True)
        counts = launch_counts()
    finally:
        server.shutdown()
    failures = []
    for status, data in res.pop("responses"):
        if status != 200 or len(data) != CLI_H * CLI_W * 3:
            failures.append(f"cli: status {status}, {len(data)} bytes")
    if any(counts.values()):
        failures.append(f"cli: kernels launched {counts}")
    return {"phase": "serve_cli", "seconds": time.perf_counter() - t0,
            "size": [CLI_H, CLI_W], "launches": counts,
            "engine": "exact DCN, unbounded warp, io_uint8, bf16",
            "failures": failures, **res}


class MemorySource:
    """An open capture over BGR uint8 frames held in memory: the methods
    `interpolate_video` calls on a `cv2.VideoCapture`."""

    def __init__(self, frames, fps: float):
        self.frames, self.fps, self.i = frames, fps, 0

    def isOpened(self) -> bool:
        return True

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]

    def get(self, prop):
        h, w = self.frames[0].shape[:2]
        return {CAP_PROP_FPS: self.fps, CAP_PROP_FRAME_WIDTH: w,
                CAP_PROP_FRAME_HEIGHT: h,
                CAP_PROP_FRAME_COUNT: len(self.frames)}[prop]

    def release(self) -> None:
        pass


class MemorySink:
    """An open writer that keeps the frames written, in order."""

    def __init__(self):
        self.frames = []

    def isOpened(self) -> bool:
        return True

    def write(self, frame) -> None:
        self.frames.append(frame)

    def release(self) -> None:
        pass


def tap_forwards(eng) -> list:
    """Keeps each of `eng`'s model forwards (one an engine launch; the
    guard splits a call into several) in the returned list, from now until
    the next tap of `eng`: its output and the device time from its first
    kernel to its last (CUDA events around it, no synchronisation)."""
    outs, forward = [], FrameInterpolator._forward.__get__(eng)

    def tapped(x, y):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = forward(x, y)
        b.record()
        outs.append((out, a, b))
        return out

    eng._forward = tapped
    return outs


def engine_device_s(outs: list) -> float:
    """Seconds of device time the tapped forwards spanned (synchronised
    first)."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for _, a, b in outs) / 1e3


def moving_frames(gen: np.random.Generator, n: int) -> list:
    """n (H, W, 3) uint8 frames of one smooth texture in a steady shift of
    (3, 6) pixels a frame, as the serve phase's sequences; read as BGR."""
    base = u8(smooth_frames(gen, 1)[0][0])
    return [np.ascontiguousarray(np.roll(base, (3 * k, 6 * k), axis=(0, 1)))
            for k in range(n)]


def launch_failures(tag: str, counts: dict, launches: int) -> list:
    return [f"{tag}: {k} {v} launches over {launches} engine launches"
            for k, v in counts.items() if v != PER_LAUNCH[k] * launches]


def phase_video(eng, plain) -> dict:
    """The single-clip pipeline over frames in memory: VIDEO_FRAMES at
    VIDEO_FPS (factor 3) through `eng` (the flagship, float io), held
    against the same pipeline through `plain` (its plain-version twin);
    then a reference_compat pass over VIDEO_COMPAT_FRAMES."""
    t0 = time.perf_counter()
    frames = moving_frames(np.random.default_rng(SEED + 3), VIDEO_FRAMES)
    kw = dict(scale=1.0, batch_pairs=VIDEO_BATCH)
    x = np.stack([to_float(f, (W, H), True) for f in frames])
    eng.midpoints(x[:4], x[1:5])            # warm-up: the b=4 launch
    torch.cuda.synchronize()
    outs = tap_forwards(eng)
    reset_launch_counts()
    sink = MemorySink()
    t1 = time.perf_counter()
    stats = interpolate_video(MemorySource(frames, VIDEO_FPS), sink, eng,
                              **kw)
    wall = time.perf_counter() - t1
    counts, by_shape = launch_counts(), shapes_now()
    launches, engine_s = len(outs), engine_device_s(outs)
    ref = MemorySink()
    interpolate_video(MemorySource(frames, VIDEO_FPS), ref, plain, **kw)

    failures = launch_failures("video", counts, launches)
    factor = stats["factor"]
    n_out = VIDEO_FRAMES + (VIDEO_FRAMES - 1) * factor
    # one batch of VIDEO_BATCH pairs; three `midpoints` calls (the
    # midpoint, then both quarter points), each split by the engine's
    # pixel guard
    want_launches = 3 * math.ceil(
        VIDEO_BATCH / (eng.max_px_per_launch // (H * W)))
    if factor != 3 or stats["frames_written"] != n_out or len(
            sink.frames) != n_out or launches != want_launches:
        failures.append(f"video: factor {factor}, {len(sink.frames)} frames "
                        f"written of {n_out}, {launches} engine launches of "
                        f"{want_launches}")
    if not all(torch.isfinite(o).all().item() for o, _, _ in outs):
        failures.append("video: non-finite engine output")
    psnrs = []
    for i, (got, want) in enumerate(zip(sink.frames, ref.frames)):
        if i % (factor + 1) == 0:           # a source frame, then factor
            if not np.array_equal(got, frames[i // (factor + 1)]):
                failures.append(f"video: source frame {i} changed")
        else:
            psnrs.append(psnr_u8(got, want))
    if not psnrs or min(psnrs) < PSNR_FLOOR_DB:
        failures.append(f"video: PSNR vs plain pipeline {min(psnrs or [0])}"
                        f" below {PSNR_FLOOR_DB} dB")

    # reference_compat: per pair the shifted midpoint `factor` times, then
    # the pair's first frame unshifted; BGR frames straight to the engine
    few = frames[:VIDEO_COMPAT_FRAMES]
    compat = MemorySink()
    interpolate_video(MemorySource(few, VIDEO_FPS), compat, eng,
                      reference_compat=True, **kw)
    xb = np.stack([to_float(f, (W, H), False) for f in few])
    mids = eng.midpoints(xb[:-1], xb[1:]).cpu().numpy()
    want = []
    for i in range(len(few) - 1):
        want += [to_u8(mids[i], False, True)] * factor + [few[i]]
    want.append(few[-1])
    compat_levels = None
    if len(compat.frames) != len(want):
        failures.append(f"video compat: {len(compat.frames)} frames, "
                        f"expected {len(want)}")
    else:
        compat_levels = max(int(np.abs(g.astype(np.int16) - w.astype(
            np.int16)).max()) for g, w in zip(compat.frames, want))
        shift = float(np.mean(np.abs(to_u8(mids[0], False, True).astype(
            np.int16) - to_u8(mids[0], False, False).astype(np.int16))))
        dup = compat.frames[:factor]
        if (compat_levels > 1 or shift < 1.0
                or not all(np.array_equal(d, dup[0]) for d in dup)):
            failures.append(f"video compat: {compat_levels} levels from the "
                            f"expected frames, shift {shift} levels")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "video", "seconds": time.perf_counter() - t0,
            "size": [H, W], "source_fps": VIDEO_FPS, "stats": stats,
            "pipeline_seconds": wall,
            "frames_written_per_s": stats["frames_written"] / wall,
            "midpoints_per_s": (stats["frames_written"] - VIDEO_FRAMES)
            / wall,
            "engine_launches": launches, "launches": counts,
            "engine_device_s": engine_s, "engine_share": engine_s / wall,
            "psnr_vs_plain_db_min": min(psnrs),
            "compat_frames": len(compat.frames),
            "compat_max_levels": compat_levels, "_by_shape": by_shape}


def phase_videos(eng, plain) -> dict:
    """VIDEOS_CLIPS clips in memory through `interpolate_videos` and one
    shared MicroBatcher over `eng`; each inserted frame against `plain`'s
    midpoint of its pair. A clip has one pair in flight at a time (its
    pipeline waits on each), so a launch of more than one pair holds pairs
    of both clips: the batcher made fewer launches than it took pairs."""
    t0 = time.perf_counter()
    gen = np.random.default_rng(SEED + 4)
    clips = [moving_frames(gen, VIDEOS_FRAMES) for _ in range(VIDEOS_CLIPS)]
    outs = tap_forwards(eng)
    reset_launch_counts()
    sinks = [MemorySink() for _ in clips]
    t1 = time.perf_counter()
    stats = interpolate_videos([MemorySource(c, VIDEOS_FPS) for c in clips],
                               sinks, eng, scale=1.0, **VIDEOS_BATCHER)
    wall = time.perf_counter() - t1
    counts, by_shape = launch_counts(), shapes_now()
    launches, engine_s = len(outs), engine_device_s(outs)
    snap = stats[0]["batcher"]
    pairs = VIDEOS_CLIPS * (VIDEOS_FRAMES - 1)
    failures = launch_failures("videos", counts, launches)
    if not snap["requests"] == pairs > snap["batches"]:
        failures.append(f"videos: {snap['requests']} pairs in "
                        f"{snap['batches']} launches: no launch held both "
                        f"clips")
    psnrs = []
    for frames, sink, st in zip(clips, sinks, stats):
        x = np.stack([to_float(f, (W, H), True) for f in frames])
        ref = plain.midpoints(x[:-1], x[1:]).cpu().numpy()
        if st["factor"] != 1 or len(sink.frames) != 2 * len(frames) - 1:
            failures.append(f"videos: factor {st['factor']}, "
                            f"{len(sink.frames)} frames written")
            continue
        for i, got in enumerate(sink.frames):
            if i % 2 == 0:
                if not np.array_equal(got, frames[i // 2]):
                    failures.append(f"videos: source frame {i} changed")
            else:
                psnrs.append(psnr_u8(got, to_u8(ref[i // 2], True, False)))
    if not psnrs or min(psnrs) < PSNR_FLOOR_DB:
        failures.append(f"videos: PSNR vs plain engine {min(psnrs or [0])} "
                        f"below {PSNR_FLOOR_DB} dB")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "videos", "seconds": time.perf_counter() - t0,
            "clips": VIDEOS_CLIPS, "frames_per_clip": VIDEOS_FRAMES,
            "batcher": snap, "pipeline_seconds": wall,
            "midpoints_per_s": pairs / wall, "engine_launches": launches,
            "engine_device_s": engine_s, "engine_share": engine_s / wall,
            "launches": counts, "psnr_vs_plain_db_min": min(psnrs),
            "_by_shape": by_shape}


def phase_infer_cli() -> dict:
    """`cli.infer.main(["two-frame", ...])` with the flagship flags on a
    val pair, natively and with `--size`: the PNG it writes, decoded
    again, equals the engine's own midpoint (kept by a tap on the class)
    truncated to uint8, bit for bit; one engine launch a request, 8 / 3 /
    1 kernel launches."""
    t0 = time.perf_counter()
    scene, a, b = INFER_PAIR
    mids, fwds = [], []
    real_mid, real_fwd = FrameInterpolator.midpoints, FrameInterpolator._forward

    def mid(self, f0, f1):
        out = real_mid(self, f0, f1)
        mids.append(out)
        return out

    def fwd(self, x, y):
        fwds.append(1)
        return real_fwd(self, x, y)

    requests, failures = [], []
    by_shape = {fn.__name__: Counter() for fn in WRAPPERS}
    with tempfile.TemporaryDirectory() as tmp:
        for size in (None, INFER_SIZE):
            out = os.path.join(tmp, f"mid{len(requests)}.png")
            argv = ["two-frame", "--frame0", os.path.join(VAL, scene, a),
                    "--frame1", os.path.join(VAL, scene, b), "--output", out,
                    "--model_path", CKPT + ".npz", *INFER_FLAGS]
            if size:
                argv += ["--size", str(size[0]), str(size[1])]
            mids.clear()
            fwds.clear()
            reset_launch_counts()
            FrameInterpolator.midpoints, FrameInterpolator._forward = mid, fwd
            t1 = time.perf_counter()
            try:
                rc = infer_cli.main(argv)
            finally:
                FrameInterpolator.midpoints = real_mid
                FrameInterpolator._forward = real_fwd
            secs = time.perf_counter() - t1
            counts = launch_counts()
            for fn, c in shapes_now().items():
                by_shape[fn].update(c)
            with open(out, "rb") as f:
                got = native.decode_png_rgb(f.read())
            want = (np.clip(mids[0][0].float().cpu().numpy(), 0, 1)
                    * 255).astype(np.uint8)
            tag = f"infer_cli {size or 'native'}"
            failures += launch_failures(tag, counts, len(fwds))
            if rc != 0 or len(mids) != 1 or len(fwds) != 1 or not (
                    np.array_equal(got, want)):
                failures.append(f"{tag}: rc {rc}, {len(fwds)} engine "
                                f"launches, PNG {got.shape} vs the engine's "
                                f"midpoint {want.shape}")
            requests.append({"size": list(got.shape[:2]), "seconds": secs,
                             "launches": counts,
                             "png_equals_midpoint": bool(
                                 np.array_equal(got, want))})
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "infer_cli", "seconds": time.perf_counter() - t0,
            "pair": list(INFER_PAIR), "flags": INFER_FLAGS,
            "requests": requests, "_by_shape": by_shape}


def shapes_now() -> dict:
    """Launches by wrapper and shape since the last reset; the chain's by
    route and shape (`launches_by_plan`), so that each route's row is
    checked against the launches that took it."""
    return {fn.__name__: Counter(fn.launches_by_plan if fn is conv_chain
                                 else fn.launches_by_shape)
            for fn in WRAPPERS}


def decode_val() -> dict:
    """Every PNG of the val set, decoded once by the port's decoder."""
    paths = sorted(glob.glob(os.path.join(VAL, "*", "*.png")))
    if not paths:
        raise AssertionError(f"no val frames under {VAL}")
    return {p: load_image(p) for p in paths}


def val_batch(frames: dict, scene: str) -> tuple:
    """The first EB triplets of one val scene: (f0, gt, f1) stacks."""
    paths = sorted(p for p in frames if os.path.basename(
        os.path.dirname(p)) == scene)
    trip = [paths[i:i + 3] for i in range(EB)]
    return tuple(np.stack([frames[t[k]] for t in trip]) for k in range(3))


def phase_q12(frames: dict, R: int = 2) -> dict:
    """q12, the 67-channel reference topology, with conv_kernel="pallas"
    on one b=4 val batch: the 67-wide offset and reconstruction chains and
    the 67-channel DCN at radius R run in the kernels. At R = Q12_R8 its
    three DCNs must run the stream design."""
    params = load_params_npz(Q12 + ".npz")
    flow = load_params_npz(Q12 + ".flow.npz")
    f0, gt, f1 = val_batch(frames, "Urban")
    kw = dict(Q12_ENGINE, dcn_max_offset=R)
    eng = FrameInterpolator(params, flow_params=flow, device="cuda",
                            conv_kernel="pallas", **kw)
    eng.midpoints(f0, f1)                  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.midpoints(f0, f1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, by_shape = launch_counts(), shapes_now()
    if counts != PER_LAUNCH:
        raise AssertionError(f"q12 R={R} launches {counts}, expected "
                             f"{PER_LAUNCH}")
    dcn_key = (67, 67, EH, EW, R)
    design = dcn_plan(67, 67, R, torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin)["design"]
    if by_shape["deform_conv2d_bounded"][dcn_key] != 3 or (
            R == Q12_R8 and design != "stream"):
        raise AssertionError(f"q12 R={R}: DCN launches "
                             f"{dict(by_shape['deform_conv2d_bounded'])} on "
                             f"the {design} design, expected 3 at {dcn_key}")
    if tuple(out.shape) != f0.shape or not torch.isfinite(out).all():
        raise AssertionError(f"q12 R={R}: bad output")
    plain = FrameInterpolator(params, flow_params=flow, device="cuda",
                              conv_kernel="pallas", use_kernels=False,
                              **kw).midpoints(f0, f1)
    vs_plain = psnr(out, plain)
    if not vs_plain >= PSNR_FLOOR_DB:
        raise AssertionError(f"q12 R={R} PSNR vs plain engine {vs_plain} "
                             f"below {PSNR_FLOOR_DB} dB")
    return {"phase": "q12" if R == 2 else f"q12_r{R}", "batch": list(f0.shape),
            "dcn_max_offset": R, "dcn_design": design, "launches": counts,
            "request_seconds": secs, "psnr_vs_plain_db": vs_plain,
            "psnr_vs_gt_db": psnr(out, torch.from_numpy(gt).cuda()),
            "_by_shape": by_shape}


def phase_eval(frames: dict) -> dict:
    """The three record sweeps through the eval entry point. Runs all
    three, then fails if any missed its record or its launch counts."""
    warm = val_batch(frames, "Army")
    results, failures = [], []
    by_shape = {fn.__name__: Counter() for fn in WRAPPERS}
    for name, ckpt, kw, record_file in SWEEPS:
        record = json.load(open(os.path.join(ROOT, "artifacts",
                                             record_file)))
        eng = FrameInterpolator(load_params_npz(ckpt + ".npz"),
                                flow_params=load_params_npz(
                                    ckpt + ".flow.npz"),
                                device="cuda", **EVAL_ENGINE, **kw)
        eng.midpoints(warm[0], warm[2])    # warm-up (not counted)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        report, batches = sweep(eng, VAL, 1, EB, load=frames.__getitem__)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        for fn, c in shapes_now().items():
            by_shape[fn].update(c)
        forwards = len(batches) * (4 if kw.get("tta") else 1)
        want = {"conv_chain": 0, "deform_conv2d_bounded": 3 * forwards,
                "bounded_warp": forwards, "conv2d": 0}
        pairs = sum(bt["n"] for bt in batches)
        quality, missed = sweep_quality(name, report, record)
        scenes = {sc: {"psnr": r["psnr"], "ssim": r["ssim"],
                       "record_psnr": record["scenes"][sc]["psnr"],
                       **({"auto_scaled": r["auto_scaled"],
                           "record_auto_scaled":
                               record["scenes"][sc]["auto_scaled"]}
                          if "auto_scaled" in r else {})}
                  for sc, r in report["scenes"].items()}
        res = {"phase": "eval", "sweep": name, "seconds": secs,
               "pairs": pairs, "pairs_per_s": pairs / secs, **quality,
               "excluded_scenes": report["excluded_scenes"],
               "forwards": forwards, "launches": counts,
               "scenes": scenes,
               "probes": [[bt["scene"], bt["probe"], bt["scaled"]]
                          for bt in batches if bt["probe"] is not None]}
        emit(res)
        results.append(res)
        if counts != want:
            failures.append(f"{name}: launches {counts}, expected {want}")
        failures += missed
    if failures:
        raise AssertionError("eval: " + "; ".join(failures))
    return {"phase": "eval_done", "sweeps": [r["sweep"] for r in results],
            "seconds": sum(r["seconds"] for r in results),
            "_by_shape": by_shape}


def sweep_quality(name: str, report: dict, record: dict) -> tuple:
    """(fields, failures) of one sweep's means against its record."""
    d_psnr = report["mean_psnr"] - record["mean_psnr"]
    d_ssim = report["mean_ssim"] - record["mean_ssim"]
    failures = []
    if not abs(d_psnr) <= PSNR_TOL_DB:
        failures.append(f"{name}: mean PSNR {report['mean_psnr']:.4f} is "
                        f"{d_psnr:+.4f} dB from its record")
    if not abs(d_ssim) <= SSIM_TOL:
        failures.append(f"{name}: mean SSIM {report['mean_ssim']:.5f} is "
                        f"{d_ssim:+.5f} from its record")
    return ({"mean_psnr": report["mean_psnr"],
             "record_psnr": record["mean_psnr"], "diff_psnr": d_psnr,
             "mean_ssim": report["mean_ssim"],
             "record_ssim": record["mean_ssim"], "diff_ssim": d_ssim},
            failures)


def phase_conv_compare(frames: dict, params, flow_params) -> list:
    """conv_kernel="xla" (the trunk on cuDNN convs) against "pallas" (the
    conv-chain kernels) on both workloads, inside one call: the flagship's
    b=1 720p requests, and the three eval sweeps. The two engines take
    turns, xla / pallas / pallas / xla; each reports its median seconds.
    Launches per forward are checked (0 or 8 chains, 3 DCN, 1 warp), the
    flagship's two outputs are held to each other (PSNR floor), and each
    sweep under "pallas" is held to its record as the eval phase holds
    "xla"."""
    order = ("xla", "pallas", "pallas", "xla")
    chains = {"xla": 0, "pallas": PER_LAUNCH["conv_chain"]}
    results, failures = [], []

    def want(ck, forwards):
        return {"conv_chain": chains[ck] * forwards,
                "deform_conv2d_bounded": 3 * forwards,
                "bounded_warp": forwards, "conv2d": 0}

    t0 = time.perf_counter()
    f0, f1 = smooth_frames(np.random.default_rng(SEED), 1)
    kw = {k: v for k, v in FLAGSHIP.items() if k != "conv_kernel"}
    engs = {ck: FrameInterpolator(params, flow_params=flow_params,
                                  device="cuda", conv_kernel=ck, **kw)
            for ck in chains}
    outs = {ck: e.midpoints(f0, f1) for ck, e in engs.items()}  # warm-up
    times = {ck: [] for ck in chains}
    for ck in order:
        reset_launch_counts()
        for _ in range(5):
            t1 = time.perf_counter()
            engs[ck].midpoints(f0, f1)
            torch.cuda.synchronize()
            times[ck].append(time.perf_counter() - t1)
        if launch_counts() != want(ck, 5):
            failures.append(f"flagship {ck}: launches {launch_counts()}")
    agree = psnr(outs["xla"], outs["pallas"])
    if not agree >= PSNR_FLOOR_DB:
        failures.append(f"flagship: xla vs pallas {agree} dB")
    med = {ck: float(np.median(t)) for ck, t in times.items()}
    results.append({"phase": "conv_compare", "workload": "flagship_720p_b1",
                    "seconds": time.perf_counter() - t0,
                    "request_seconds": times,
                    "frames_per_s": {ck: 1.0 / m for ck, m in med.items()},
                    "psnr_xla_vs_pallas_db": agree,
                    "faster": min(med, key=med.get)})
    emit(results[-1])

    warm = val_batch(frames, "Army")
    for name, ckpt, skw, record_file in SWEEPS:
        t0 = time.perf_counter()
        record = json.load(open(os.path.join(ROOT, "artifacts",
                                             record_file)))
        p, fp = (load_params_npz(ckpt + ".npz"),
                 load_params_npz(ckpt + ".flow.npz"))
        ekw = {k: v for k, v in EVAL_ENGINE.items() if k != "conv_kernel"}
        engs = {ck: FrameInterpolator(p, flow_params=fp, device="cuda",
                                      conv_kernel=ck, **ekw, **skw)
                for ck in chains}
        for e in engs.values():
            e.midpoints(warm[0], warm[2])
        times, reports = {ck: [] for ck in chains}, {}
        for ck in order:
            torch.cuda.synchronize()
            reset_launch_counts()
            t1 = time.perf_counter()
            reports[ck], batches = sweep(engs[ck], VAL, 1, EB,
                                         load=frames.__getitem__)
            torch.cuda.synchronize()
            times[ck].append(time.perf_counter() - t1)
            forwards = len(batches) * (4 if skw.get("tta") else 1)
            if launch_counts() != want(ck, forwards):
                failures.append(f"{name} {ck}: launches {launch_counts()}")
        pairs = sum(bt["n"] for bt in batches)
        med = {ck: float(np.median(t)) for ck, t in times.items()}
        quality, missed = sweep_quality(f"{name} pallas", reports["pallas"],
                                        record)
        failures += missed
        results.append({
            "phase": "conv_compare", "workload": f"eval_{name}",
            "seconds": time.perf_counter() - t0, "sweep_seconds": times,
            "pairs_per_s": {ck: pairs / m for ck, m in med.items()},
            "faster": min(med, key=med.get),
            "xla_mean_psnr": reports["xla"]["mean_psnr"],
            "pallas": quality})
        emit(results[-1])
    if failures:
        raise AssertionError("conv_compare: " + "; ".join(failures))
    return results


def phase_tools() -> dict:
    """The two ported kernel tools, in-process on the card at a few
    iterations (`TOOL_RUNS`): every kernel row of their output within the
    tolerance of its plain version, and each of the conv, DCN and warp
    kernels launched. The shapes they launch are the `tools` path's."""
    t0 = time.perf_counter()
    reset_launch_counts()
    results, failures = [], []
    for tool, argv in TOOL_RUNS:
        t1 = time.perf_counter()
        res = tool.main(argv)
        checked = 0
        for row in res["rows"]:
            if "refused" in row or row["kernel"] in TOOL_LIBRARY:
                continue
            checked += 1
            if not row["max_abs_err"] <= REL_TOL * row["ref_max_abs"]:
                failures.append(f"{res['tool']} {row}")
        results.append({"tool": res["tool"], "argv": argv,
                        "seconds": time.perf_counter() - t1,
                        "kernel_rows_checked": checked, "rows": res["rows"]})
    counts = launch_counts()
    for k in ("conv2d", "deform_conv2d_bounded", "bounded_warp"):
        if counts[k] == 0:
            failures.append(f"the tools launched no {k}")
    if failures:
        raise AssertionError("tools: " + "; ".join(failures))
    return {"phase": "tools", "seconds": time.perf_counter() - t0,
            "launches": counts, "runs": results, "_by_shape": shapes_now()}


def grad_case(name, kernel, plain, inputs) -> dict:
    """Gradients of sum(out * cot) through `kernel` and through `plain`
    with respect to every floating input: the kernel's output carries a
    grad_fn, each gradient is within 2**-7 * max|plain gradient| and
    non-zero wherever the plain one is."""
    grads, launches = {}, None
    for tag, fn in (("kernel", kernel), ("plain", plain)):
        leaves = [None if t is None else t.detach().clone().requires_grad_()
                  for t in inputs]
        reset_launch_counts()
        out = fn(*leaves)
        if tag == "kernel":
            launches = sum(launch_counts().values())
            if out.grad_fn is None or launches != 1:
                raise AssertionError(f"grad {name}: grad_fn {out.grad_fn}, "
                                     f"{launches} launches")
        cot = torch.randn(out.shape, device=out.device,
                          generator=torch.Generator(out.device).manual_seed(1))
        (out.float() * cot).sum().backward()
        grads[tag] = [None if t is None else t.grad for t in leaves]
    errs = []
    for i, (gk, gp) in enumerate(zip(grads["kernel"], grads["plain"])):
        if gp is None:
            continue
        res = check_close(f"grad {name} input {i}", gk, gp)
        lost = int(((gk == 0) & (gp != 0)).sum().item())
        if lost:
            raise AssertionError(f"grad {name} input {i}: {lost} entries "
                                 f"zero where the plain gradient is not")
        errs.append(res["max_abs_err"] / max(res["tol"] * 2 ** 7, 1e-30))
    return {"name": name, "max_rel_err": max(errs), "inputs": len(errs)}


def phase_grad(dev) -> dict:
    """Gradients through each kernel wrapper against those through its
    plain version at GRAD_SHAPE: bf16 activations, float32 weights (as
    the model holds its parameters)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b, h, w = GRAD_SHAPE

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    x = rnd(b, h, w, 64)
    w3 = [rnd(co, ci, 3, 3, scale=(9 * ci) ** -0.5, dtype=torch.float32)
          for ci, co in ((64, 64), (64, 32), (32, 8))]
    b3 = [rnd(co, scale=0.1, dtype=torch.float32) for co in (64, 32, 8)]
    w27 = rnd(27, 64, 3, 3, scale=1 / 24, dtype=torch.float32)
    b27 = rnd(27, scale=0.1, dtype=torch.float32)
    off = rnd(b, h, w, 18, scale=1.5)
    mask = torch.sigmoid(rnd(b, h, w, 9, scale=2.0).float()).to(
        torch.bfloat16)
    img3, img64 = rnd(b, h, w, 3), rnd(b, h, w, 64)
    flow = rnd(b, h, w, 2, scale=3.0)
    # The stream design's width (no tile plan holds C=128).
    x128 = rnd(b, h, w, 128)
    w128 = rnd(128, 128, 3, 3, scale=1 / 34, dtype=torch.float32)
    b128 = rnd(128, scale=0.1, dtype=torch.float32)
    acts = (True, True, False)
    cases = [
        grad_case("conv2d", lambda x, wt, bt: conv2d(x, wt, bt, True),
                  lambda x, wt, bt: conv2d_plain(x, wt, bt, True),
                  [x, w3[1], b3[1]]),
        grad_case("conv_chain",
                  lambda x, *p: conv_chain(x, p[:3], p[3:], acts),
                  lambda x, *p: conv_chain_plain(x, p[:3], p[3:], acts),
                  [x, *w3, *b3]),
        grad_case("conv_chain/fused",
                  lambda x, *p: conv_chain(x, p[:3], p[3:], acts,
                                           route="fused"),
                  lambda x, *p: conv_chain_plain(x, p[:3], p[3:], acts),
                  [x, *w3, *b3]),
        grad_case("conv_chain/L1",
                  lambda x, w, b: conv_chain(x, [w], [b], (False,)),
                  lambda x, w, b: conv_chain_plain(x, [w], [b], (False,)),
                  [x, w27, b27]),
        grad_case("deform_conv2d_bounded",
                  lambda *a: deform_conv2d_bounded(*a, 2),
                  lambda *a: deform_conv2d_bounded_plain(*a, 2),
                  [x, off, mask, w3[0], b3[0]]),
        grad_case("deform_conv2d_bounded/stream C128R4",
                  lambda *a: deform_conv2d_bounded(*a, 4),
                  lambda *a: deform_conv2d_bounded_plain(*a, 4),
                  [x128, off, mask, w128, b128]),
        grad_case("bounded_warp/C3", lambda i, f: bounded_warp(i, f, 4),
                  lambda i, f: bounded_warp_plain(i, f, 4), [img3, flow]),
        grad_case("bounded_warp/C64", lambda i, f: bounded_warp(i, f, 4),
                  lambda i, f: bounded_warp_plain(i, f, 4), [img64, flow]),
    ]
    return {"phase": "grad", "seconds": time.perf_counter() - t0,
            "shape": list(GRAD_SHAPE), "rel_tol": REL_TOL, "cases": cases}


def kernel_launches(rows: list, by_path: dict) -> list:
    """Each row's launches, summed over its paths' runs (null for a shape
    no path takes). Fails when a row's path never launched its shape, and
    when a path launched a (wrapper, shape) that no row of that path
    checks and times."""
    kernels, covered = [], set()
    for row in rows:
        paths, fn_name, key = row.pop("_key")
        per_path = {p: by_path[p][fn_name].get(key, 0) for p in paths}
        for p, n in per_path.items():
            if n == 0:
                raise AssertionError(f"{row['name']}: never launched on the "
                                     f"{p} path")
            covered.add((p, fn_name, key))
        row["launches"] = sum(per_path.values()) if paths else None
        row["launches_by_path"] = per_path
        row.pop("tol")
        kernels.append(row)
    unchecked = [(p, fn_name, key) for p, shapes in by_path.items()
                 for fn_name, counts in shapes.items()
                 for key, n in counts.items()
                 if n and (p, fn_name, key) not in covered]
    if unchecked:
        raise AssertionError(f"launched at shapes no kernel row checks: "
                             f"{unchecked}")
    return kernels


PORT_KERNELS = ("conv_chain_kernel", "conv2d_kernel", "dcn_tile_kernel",
                "dcn_stream_kernel", "warp_bounded_kernel",
                "warp_bounded_wide_kernel", "warp_bounded_wide_2b_kernel")


def phase_profile(eng, request) -> dict:
    """Device time of one b=1 request by kernel, and the device's busy
    share of the request's wall time (union of kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        eng.midpoints(*request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        if b <= a:
            continue
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
    if not spans:
        raise AssertionError("profiler recorded no device activity")
    spans.sort()
    busy, cur_a, cur_b = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy = (busy + cur_b - cur_a) / 1e3
    port = sum(v for k, v in by_name.items()
               if any(p in k for p in PORT_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "profile", "seconds": time.perf_counter() - t0,
            "request_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "device_kernel_ms": sum(by_name.values()),
            "port_kernels_ms": port, "other_kernels_ms":
            sum(by_name.values()) - port, "n_kernel_names": len(by_name),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    card = card_line()
    emit({"phase": "card", "seconds": time.perf_counter() - t0,
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    emit(phase_build())

    params = load_params_npz(CKPT + ".npz")
    flow_params = load_params_npz(CKPT + ".flow.npz")
    sd = params_from_jax(params)
    sd12 = params_from_jax(load_params_npz(Q12 + ".npz"))

    t0 = time.perf_counter()
    rows = phase_kernels(sd, sd12, dev)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})

    by_path = {}
    t0 = time.perf_counter()
    main_res = phase_main(params, flow_params)
    by_path["main"] = main_res.pop("_by_shape")
    eng, request = main_res.pop("_engine"), main_res.pop("_request")
    main_res["seconds"] = time.perf_counter() - t0
    main_res["card"] = card
    emit(main_res)

    serve_res = phase_serve(params, flow_params)
    by_path["serve"] = serve_res.pop("_by_shape")
    emit(serve_res)

    veng = FrameInterpolator(params, flow_params=flow_params, device="cuda",
                             **FLAGSHIP)
    vplain = FrameInterpolator(params, flow_params=flow_params,
                               device="cuda", use_kernels=False, **FLAGSHIP)
    for path, phase in (("video", phase_video), ("videos", phase_videos)):
        res = phase(veng, vplain)
        by_path[path] = res.pop("_by_shape")
        emit(res)
    del veng, vplain
    infer_res = phase_infer_cli()
    by_path["infer_cli"] = infer_res.pop("_by_shape")
    emit(infer_res)

    t0 = time.perf_counter()
    frames = decode_val()
    emit({"phase": "decode", "seconds": time.perf_counter() - t0,
          "pngs": len(frames)})
    for R, path in ((2, "q12"), (Q12_R8, "q12_r8")):
        t0 = time.perf_counter()
        q12_res = phase_q12(frames, R)
        by_path[path] = q12_res.pop("_by_shape")
        q12_res["seconds"] = time.perf_counter() - t0
        emit(q12_res)
    eval_res = phase_eval(frames)
    by_path["eval"] = eval_res.pop("_by_shape")
    emit(eval_res)
    phase_conv_compare(frames, params, flow_params)
    tools_res = phase_tools()
    by_path["tools"] = tools_res.pop("_by_shape")
    emit(tools_res)
    emit(phase_grad(dev))
    if "--profile" in sys.argv[1:]:
        emit(phase_profile(eng, request))

    emit({"kernels": kernel_launches(rows, by_path)})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
