"""Per-layer microbench of the port's conv kernel against cuDNN at 720p.

    python -m vfi_tpu_torch.tools.bench_conv [--b N] [--h H] [--w W]
        [--shapes 64x64,...|all] [--kernels xla,im2col,direct,v2,plain]
        [--iters N] [--device cuda|cpu] [--smoke]

The counterpart of the JAX package's `tools/bench_conv.py`: one stride-1
3x3 conv + bias + ReLU, bf16 NHWC, random weights from a seeded numpy
generator, for each (Cin, Cout) of `--shapes` (`all` = 64x64, 128x64,
64x32, 6x64) and each kernel of `--kernels`:

- `xla`: the library conv, `F.conv2d` in bf16 with the bias, then ReLU
  (cuDNN on the card);
- `im2col`, `direct`, `v2`: the port's conv kernel (`ops.cuda.conv2d`)
  under each TPU variant's contract; one kernel serves all three, and "v2"
  refuses Cin outside {64, 128} as `conv2d_pallas_v2` does;
- `plain`: `conv2d_plain`, the kernel's plain PyTorch version.

The reference's `:dbg` kernel suffixes were TPU cost-split ablations that
gave wrong results and are not carried over, nor is its chaining of
iterations through the weights (a TPU relay's memoisation workaround).
Times are CUDA-event medians of `--iters` interleaved rounds. Each line
gives ms, TF/s and the max abs error against `plain`; a refused (shape,
kernel) prints its ValueError. The last line is one JSON object with every
row. `--smoke` runs a 1x8x16 shape, on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from vfi_tpu_torch.infer.pair import resolve_device
from vfi_tpu_torch.ops.cuda import conv2d, conv2d_plain
from vfi_tpu_torch.tools import max_abs_err, time_interleaved

ITERS = 20
ALL_SHAPES = ((64, 64), (128, 64), (64, 32), (6, 64))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--shapes", default="64x64",
                    help="comma list of cinxcout, or 'all'")
    ap.add_argument("--kernels", default="xla,im2col,direct")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a 1x8x16 shape (runs on the CPU with --device cpu)")
    return ap.parse_args(argv)


def kernel_fn(name: str, x, wt, bs):
    if name == "xla":
        xn = x.permute(0, 3, 1, 2)
        wb, bb = wt.to(x.dtype), bs.to(x.dtype)
        return lambda: torch.relu(F.conv2d(xn, wb, bb, padding=1)).permute(
            0, 2, 3, 1)
    if name == "plain":
        return lambda: conv2d_plain(x, wt, bs, act=True)
    return lambda: conv2d(x, wt, bs, act=True, variant=name)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    b, h, w = (1, 8, 16) if args.smoke else (args.b, args.h, args.w)
    shapes = (ALL_SHAPES if args.shapes == "all" else
              [tuple(int(v) for v in s.split("x"))
               for s in args.shapes.split(",")])
    kernels = args.kernels.split(",")
    rng = np.random.default_rng(0)
    dt = torch.bfloat16
    print(f"device {dev} b{b} {h}x{w}", flush=True)
    rows = []
    for cin, cout in shapes:
        x = torch.from_numpy(rng.standard_normal((b, h, w, cin),
                                                 np.float32)).to(dev, dt)
        wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * 0.05
                               ).astype(np.float32)).to(dev)
        bs = torch.from_numpy(rng.standard_normal((cout,)).astype(
            np.float32)).to(dev)
        flops = 2.0 * b * h * w * 9 * cin * cout
        ref = conv2d_plain(x, wt, bs, act=True)
        fns, timed = {}, []
        for name in kernels:
            fn = kernel_fn(name, x, wt, bs)
            row = {"cin": cin, "cout": cout, "kernel": name}
            rows.append(row)
            try:
                row.update(max_abs_err(fn(), ref))
            except ValueError as e:   # the variant's contract refuses it
                row["refused"] = str(e)
                print(f"b{b} {cin:3d}->{cout:3d} {name:8s} refused: {e}",
                      flush=True)
                continue
            fns[name] = fn
            timed.append(row)
        times = time_interleaved(fns, args.iters, dev)
        for row in timed:
            ms = times[row["kernel"]]
            row.update(ms=ms, tflops=flops / ms / 1e9)
            print(f"b{b} {cin:3d}->{cout:3d} {row['kernel']:8s} {ms:8.3f} ms"
                  f"  {row['tflops']:6.2f} TF/s  err {row['max_abs_err']:.3g}",
                  flush=True)
    result = {"tool": "bench_conv", "device": str(dev), "b": b, "h": h,
              "w": w, "iters": args.iters, "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
