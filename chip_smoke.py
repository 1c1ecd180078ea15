#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vfi_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line with its `seconds`; any failure raises
and the script exits non-zero without a result line:

1. card    the card's name and power limit (nvidia-smi);
2. build   the one `nvcc` build of `vfi_tpu_torch/csrc/*.cu`;
3. kernels each CUDA kernel at the 720p main-path shapes in bf16, held
           against its plain PyTorch version (max abs error within the
           stated tolerance), then timed with CUDA events (median of
           N_TIMED runs after warm-up) beside its plain version, one
           PyTorch library call where one computes the same function, and
           its bound from bytes and operations;
4. main    the flagship engine (qocc checkpoint + flow prior, bf16,
           dcn_max_offset=1, warp_max_flow=16, cascade_levels=2) answers
           three b=1 requests and one b=2 request at 1280x720 on the card:
           launch counts (8 conv-chain, 3 DCN, 1 warp per engine launch),
           finite outputs in [0, 1], PSNR against the same engine run
           through the plain versions on the card, frames/s;
5. profile (only with --profile) torch.profiler over one b=1 request: the
           device's busy share of the request's wall time and device time
           by kernel, split into the port's CUDA kernels and the rest.

The lines before the last are the `kernels` JSON line and the card's
`nvidia-smi --query-gpu=name,power.limit` line; the last line is
`{"ok": true, "device": {...}}`. Imports only torch, numpy and the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import vfi_tpu_torch
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.ops.cuda import (WRAPPERS, bounded_warp,
                                    bounded_warp_plain, build, conv_chain,
                                    conv_chain_plain, deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain,
                                    launch_counts, pack_conv_chain, pack_dcn,
                                    reset_launch_counts)
from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(vfi_tpu_torch.__file__)))
CKPT = os.path.join(ROOT, "artifacts", "emavfi_qocc_best")
H, W = 720, 1280
SEED = 0
N_TIMED = 20
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
                cascade_levels=2)
# Launches of each kernel per engine launch on the flagship path.
PER_LAUNCH = {"conv_chain": 8, "deform_conv2d_bounded": 3, "bounded_warp": 1}
CHAIN_TPU = "vfi_tpu/ops/pallas/conv.py:543"
DCN_TPU = "vfi_tpu/ops/pallas/sampling.py:1027"
WARP_TPU = "vfi_tpu/ops/pallas/sampling.py:739"


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


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
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
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "nvcc_seconds": info["seconds"], "cached": info["cached"],
            "ptxas": ptxas}


def kernel_row(name, source, replaces, key, kernel, plain, library,
               io_bytes, flops_bf16, flops_f32=0.0) -> dict:
    """Check one kernel call against its plain version, then time the
    kernel, the plain version and (where one exists) a library call."""
    got = kernel()
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, **check_close(name, got, plain())}
    row["ms"] = median_ms(kernel)
    row["plain_ms"] = median_ms(plain)
    row["library_ms"] = None if library is None else median_ms(library)
    row["bound_ms"], row["bound_by"] = bound(io_bytes + nbytes(got),
                                             flops_bf16, flops_f32)
    emit({"phase": "kernel", **row})
    row["_key"] = key
    return row


def phase_kernels(sd: dict, dev) -> list:
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
    shapes = [(H, W, c) for c in chains] + [
        (H // 2, W // 2, c) for c in chains[:2]]
    for h, w, (tag, cin, names, acts) in shapes:
        ws = [sd[f"{n}.weight"].to(dev) for n in names]
        bs = [sd[f"{n}.bias"].to(dev) for n in names]
        acts = tuple(bool(a) for a in acts)
        x = rnd(1, h, w, cin)
        library = None
        if len(ws) == 1:  # one conv: cuDNN computes the same function
            xn, wb, bb = x.permute(0, 3, 1, 2), ws[0].to(bf), bs[0].to(bf)
            library = lambda: F.conv2d(xn, wb, bb, padding=1)  # noqa: E731
        chans = tuple([cin] + [wt.shape[0] for wt in ws])
        pk = pack_conv_chain(ws, bs)       # packed once, as the engine does
        rows.append(kernel_row(
            f"conv_chain/{tag}@{h}x{w}", "vfi_tpu_torch/csrc/conv_chain.cu",
            CHAIN_TPU, ("conv_chain", (chans, h, w)),
            lambda: conv_chain(x, ws, bs, acts, packed=pk),
            lambda: conv_chain_plain(x, ws, bs, acts), library,
            nbytes(x) + nbytes(*ws) // 2 + nbytes(*bs),
            sum(2.0 * h * w * 9 * wt.shape[1] * wt.shape[0] for wt in ws)))

    # Bounded DCN at the fusion stack's shape; offsets reach past R = 1 so
    # the clamp is exercised. No single PyTorch call computes it
    # (torchvision is absent), so no library time.
    x = rnd(1, H, W, 64)
    off = rnd(1, H, W, 18, scale=0.8)
    mask = torch.sigmoid(rnd(1, H, W, 9, scale=2.0).float()).to(bf)
    wt, bt = sd["fusion_dcn0.weight"].to(dev), sd["fusion_dcn0.bias"].to(dev)
    pk_dcn = pack_dcn(wt, bt)
    rows.append(kernel_row(
        f"deform_conv2d_bounded@{H}x{W}", "vfi_tpu_torch/csrc/dcn_bounded.cu",
        DCN_TPU, ("deform_conv2d_bounded", (64, 64, H, W)),
        lambda: deform_conv2d_bounded(x, off, mask, wt, bt, 1,
                                      packed=pk_dcn),
        lambda: deform_conv2d_bounded_plain(x, off, mask, wt, bt, 1), None,
        nbytes(x, off, mask) + nbytes(wt) // 2 + nbytes(bt),
        2.0 * H * W * 9 * 64 * 64, 8.0 * H * W * 9 * 64))

    # Bounded warp of the RGB frame; flows reach past R = 16. The library
    # call is grid_sample on the clamped flow's normalized grid.
    img = rnd(1, H, W, 3)
    flow = rnd(1, H, W, 2, scale=10.0)
    fc = flow.float().clamp(-16, 16)
    gx = (torch.arange(W, device=dev).float() + fc[..., 0]) * (2 / (W - 1)) - 1
    gy = (torch.arange(H, device=dev).float()[:, None] + fc[..., 1]) * (
        2 / (H - 1)) - 1
    grid, imn = torch.stack([gx, gy], dim=-1).to(bf), img.permute(0, 3, 1, 2)
    rows.append(kernel_row(
        f"bounded_warp@{H}x{W}", "vfi_tpu_torch/csrc/warp_bounded.cu",
        WARP_TPU, ("bounded_warp", (3, H, W)),
        lambda: bounded_warp(img, flow, 16),
        lambda: bounded_warp_plain(img, flow, 16),
        lambda: F.grid_sample(imn, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=True),
        nbytes(img, flow), 0.0, 40.0 * H * W))
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
    by_shape = {fn.__name__: dict(fn.launches_by_shape) for fn in WRAPPERS}

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


PORT_KERNELS = ("conv_chain_kernel", "dcn_bounded_kernel",
                "warp_bounded_kernel")


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

    t0 = time.perf_counter()
    rows = phase_kernels(sd, dev)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    main_res = phase_main(params, flow_params)
    by_shape = main_res.pop("_by_shape")
    eng, request = main_res.pop("_engine"), main_res.pop("_request")
    main_res["seconds"] = time.perf_counter() - t0
    main_res["card"] = card
    emit(main_res)
    if "--profile" in sys.argv[1:]:
        emit(phase_profile(eng, request))

    kernels = []
    for row in rows:
        fn_name, key = row.pop("_key")
        row["launches"] = by_shape[fn_name].get(key, 0)
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']}: never launched on the main "
                                 "path")
        row.pop("tol")
        kernels.append(row)
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
