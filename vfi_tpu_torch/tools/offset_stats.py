"""Active (tap, shift) pairs of a checkpoint's DCN offsets on real frames.

    python -m vfi_tpu_torch.tools.offset_stats
        [--ckpt artifacts/emavfi_long2_best.npz] [--scene Urban]
        [--radius 2] [--th 8] [--wchunk 128] [--device cuda|cpu] [--smoke]

The counterpart of the JAX package's `tools/offset_stats.py`. The TPU DCN
kernels skipped the (tap, column-shift) pairs whose per-slab offset
bounds leave them inactive; this counts, from a trained checkpoint's real
offsets, how many pairs a block of `--th` rows by the full width, and by
`--wchunk` columns, activates (`pair_stats`, a copy of the JAX tool's).
One forward of the checkpoint's model in float32 (dcn_max_offset
`--radius`, warp_max_flow 16, `fuse_project` read off the tree; the
float32 kernels on the card) on a Middlebury val scene's frames 10 and 11
at their native 480x640 (`data/processed/val/<scene>`, the port's PNG
codec); each DCN's offsets are caught as `dump_offsets` catches them and
clamped to R. One line a layer, as the JAX tool prints it, then one JSON
object. `--smoke` runs the top-left 16x32 of the frames with `--wchunk`
at most 16, on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vfi_tpu_torch.infer.pair import resolve_device
from vfi_tpu_torch.tools import build_model
from vfi_tpu_torch.tools.dump_offsets import load_pair, offset_planes

SMOKE = (16, 32)
NATIVE = (480, 640)


def pair_stats(dx: np.ndarray, R: int, th: int, wchunk: int) -> float:
    """Mean active column-shift pairs per (th x wchunk) block (9 taps)."""
    H, W, T = dx.shape
    nr, nc = H // th, W // wchunk
    b = dx[:nr * th, :nc * wchunk].reshape(nr, th, nc, wchunk, T)
    mn = b.min(axis=(1, 3))
    mx = b.max(axis=(1, 3))
    sx = np.arange(-R, R + 1).reshape(1, 1, 1, -1)
    act = (mx[..., None] > sx - 1) & (mn[..., None] < sx + 1)
    return float(act.sum(axis=-1).sum(axis=-1).mean())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default="artifacts/emavfi_long2_best.npz")
    p.add_argument("--scene", default="Urban")
    p.add_argument("--radius", type=int, default=2)
    p.add_argument("--th", type=int, default=8)
    p.add_argument("--wchunk", type=int, default=128)
    p.add_argument("--device", default="cuda")
    p.add_argument("--smoke", action="store_true",
                   help="the frames' top-left 16x32 (runs on the CPU with "
                        "--device cpu)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    f0, f1 = load_pair(args.scene, *NATIVE)
    wchunk = args.wchunk
    if args.smoke:
        f0, f1 = (f[:, :SMOKE[0], :SMOKE[1]].copy() for f in (f0, f1))
        wchunk = min(wchunk, 16)
    model = build_model(args.ckpt, dev, dcn_max_offset=args.radius,
                        warp_max_flow=16)
    planes = offset_planes(model, torch.from_numpy(f0).to(dev),
                           torch.from_numpy(f1).to(dev))
    R = args.radius
    layers = []
    for li in range(model.num_blocks):
        off = planes[f"offset_l{li}"][0]             # (dy, dx) interleaved
        dy = np.clip(off[..., 0::2], -R, R)
        dx = np.clip(off[..., 1::2], -R, R)
        W = dx.shape[1]
        row = {"layer": li,
               "pairs_full_w": pair_stats(dx, R, args.th, W),
               "pairs_wchunk": pair_stats(dx, R, args.th, wchunk),
               "dx_p99": float(np.percentile(np.abs(dx), 99)),
               "dy_p99": float(np.percentile(np.abs(dy), 99))}
        layers.append(row)
        print(f"{args.scene} dcn{li}: "
              f"dx pairs/slab full-W {row['pairs_full_w']:.1f}  "
              f"per-{wchunk} {row['pairs_wchunk']:.1f}"
              f"  (9 = zero-offset floor, {9 * (2 * R + 1)} = worst case); "
              f"|dx| p99 {row['dx_p99']:.2f} |dy| p99 {row['dy_p99']:.2f}",
              flush=True)
    result = {"tool": "offset_stats", "device": str(dev), "ckpt": args.ckpt,
              "scene": args.scene, "radius": R, "th": args.th,
              "wchunk": wchunk, "h": f0.shape[1], "w": f0.shape[2],
              "layers": layers}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
