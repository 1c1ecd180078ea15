"""Host time of the bounded warp's launch path, piece by piece, in several
checkouts.

    python -m vfi_tpu_torch.tools.launch_path --trees A,B,B,A [--b 1]
        [--h 720] [--w 1280] [--calls 1000]

The RGB warp (`ops.cuda.bounded_warp`, C=3, R=16) moves a few MB: at the
main path's shapes its kernel runs for microseconds, and a synchronised
call is mostly the wrapper's host path. For each entry of `--trees` (the
root of a checkout, as in `conv_turns`), one Python process imports that
checkout's `vfi_tpu_torch` and times, each with `time.perf_counter_ns`
over `--calls` calls, on the card:

- `pieces_per_call`: each step of a launch path on its own. `lookup`:
  the steps a wrapper took with a library lookup, a stream object and two
  closures per call (argument checks through `t.device.type`,
  `needs_grad` and the closures, `torch.empty_like`, `build.load()`,
  `torch.cuda.current_stream(dev).cuda_stream`, the ctypes call looked
  up on the library, `build.check`, the two counters); `bound`, where the
  checkout has `build.entry`: the steps of a wrapper that binds its entry
  once and reads the raw stream (the device, dtype and contiguity test of
  the common case, the grad test, `torch.empty_like`, `build.entry`,
  `build.current_stream`, the ctypes call, the counters). Each ctypes
  call launches the kernel.
- `host_us`: one whole call of the wrapper and of `F.grid_sample` on the
  clipped flow's grid, no synchronise between calls;
- `ms`: median of 20 synchronised calls between two events (as
  `chip_smoke.py`'s `ms`), and `device_ms` (its `device_ms`).

All times are microseconds per call but `ms` and `device_ms`. Prints one
line per tree; the last line is one JSON object with every row. Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CALLS = 1000

CHILD = r"""
import json, sys, time
import numpy as np
import torch
import torch.nn.functional as F
args = json.loads(sys.argv[1])
sys.path.insert(0, args["tree"])
from vfi_tpu_torch.ops.cuda import bounded_warp, build
from vfi_tpu_torch.ops.cuda.grad import needs_grad
if not torch.cuda.is_available():
    raise SystemExit("launch_path needs a card")
dev = torch.device("cuda", 0)
b, h, w, n, R = args["b"], args["h"], args["w"], args["calls"], 16
rng = np.random.default_rng(0)
img = torch.from_numpy(rng.uniform(0.0, 1.0, (b, h, w, 3)).astype(
    np.float32)).to(dev, torch.bfloat16)
flow = torch.from_numpy((rng.standard_normal((b, h, w, 2)) * 10.0).astype(
    np.float32)).to(dev, torch.bfloat16)
fc = flow.float().clamp(-R, R)
gx = (torch.arange(w, device=dev).float() + fc[..., 0]) * (2 / (w - 1)) - 1
gy = (torch.arange(h, device=dev).float()[:, None] + fc[..., 1]) * (
    2 / (h - 1)) - 1
grid = torch.stack([gx, gy], dim=-1).to(torch.bfloat16)
imn = img.permute(0, 3, 1, 2)
build.load()   # built before anything is timed
out = torch.empty_like(img)


def per_call_us(fn):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / n / 1e3


def median_ms(fn):
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_ms(fn, k=100):
    spin = 1 << 22
    while True:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin)
        e0.record()
        for _ in range(k):
            fn()
        e1.record()
        queued_first = not e0.query()
        e1.synchronize()
        if queued_first:
            return e0.elapsed_time(e1) / k
        spin *= 2


def checks_by_device_type(name, **tensors):
    d = None
    for k, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(k)
        if t.dtype != torch.bfloat16:
            raise TypeError(k)
        if not t.is_contiguous():
            raise ValueError(k)
        if d is not None and t.device != d:
            raise ValueError(k)
        d = t.device
    return d


def closures():
    needs_grad(img, flow)

    def launch(image, flow):
        return image

    def plain(image, flow):
        return image
    return launch, plain


counter = {"n": 0}
shapes = {}


def counters():
    counter["n"] += 1
    shapes[(3, h, w, R)] = shapes.get((3, h, w, R), 0) + 1


# (a checkout whose warp entry takes the output's pixel stride: 3 here)
oc = (3,) * (len(getattr(build, "SIGNATURES", {}).get(
    "vfi_warp_bounded_bf16", ())) == 11)
args_ptr = (img.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, 3,
            *oc, float(R), 0)
pieces = {"lookup": {
    "shape_checks": lambda: (img.dim() != 4 or tuple(flow.shape) != tuple(
        img.shape[:3]) + (2,) or img.device.type == "cpu"),
    "device_dtype_contiguity": lambda: checks_by_device_type(
        "bounded_warp", image=img, flow=flow),
    "needs_grad_and_closures": closures,
    "empty_like": lambda: torch.empty_like(img),
    "build_load": build.load,
    "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
    "ctypes_call": lambda: build.load().vfi_warp_bounded_bf16(
        *args_ptr, torch.cuda.current_stream(dev).cuda_stream),
    "check_rc": lambda: build.check(0, "bounded_warp"),
    "counters": counters,
}}
if hasattr(build, "entry"):
    entry = build.entry("vfi_warp_bounded_bf16")
    stream = build.current_stream(0)
    pieces["bound"] = {
        "shape_checks": lambda: (img.dim() != 4 or flow.shape != (
            *img.shape[:3], 2) or not img.is_cuda),
        "device_dtype_contiguity": lambda: (
            flow.get_device() == img.get_device() >= 0 and img.dtype
            is flow.dtype is torch.bfloat16 and img.is_contiguous()
            and flow.is_contiguous()),
        "needs_grad": lambda: torch.is_grad_enabled() and (
            img.requires_grad or flow.requires_grad),
        "empty_like": lambda: torch.empty_like(img),
        "entry": lambda: build.entry("vfi_warp_bounded_bf16"),
        "stream": lambda: build.current_stream(0),
        "ctypes_call": lambda: entry(*args_ptr, stream),
        "counters": counters,
    }
row = {"tree": args["tree"], "b": b, "h": h, "w": w, "calls": n,
       "pieces_per_call": {k: {p: per_call_us(f) for p, f in v.items()}
                           for k, v in pieces.items()}}
warp = lambda: bounded_warp(img, flow, R)
gs = lambda: F.grid_sample(imn, grid, mode="bilinear", padding_mode="zeros",
                           align_corners=True)
row["host_us"] = {"bounded_warp": per_call_us(warp),
                  "grid_sample": per_call_us(gs)}
row["ms"] = {"bounded_warp": median_ms(warp), "grid_sample": median_ms(gs)}
row["device_ms"] = {"bounded_warp": device_ms(warp),
                    "grid_sample": device_ms(gs)}
row["card"] = torch.cuda.get_device_name(0)
print(json.dumps(row))
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=".",
                    help="comma list of checkout roots, in turn order")
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--calls", type=int, default=CALLS)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    rows = []
    for turn, tree in enumerate(os.path.abspath(t)
                                for t in args.trees.split(",")):
        child = {"tree": tree, "b": args.b, "h": args.h, "w": args.w,
                 "calls": args.calls}
        res = subprocess.run([sys.executable, "-c", CHILD, json.dumps(child)],
                             cwd=tree, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"launch_path: {tree} failed:\n{res.stderr}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["turn"] = turn
        rows.append(row)
        print(f"turn {turn} {tree}  wrapper {row['host_us']['bounded_warp']:.2f}"
              f" us  grid_sample {row['host_us']['grid_sample']:.2f} us",
              flush=True)
    result = {"tool": "launch_path", "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
