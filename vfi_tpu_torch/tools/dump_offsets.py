"""Dump a checkpoint's per-DCN-layer offset and mask planes to an npz.

    python -m vfi_tpu_torch.tools.dump_offsets --out planes.npz
        [--ckpt artifacts/emavfi_q2_best.npz] [--scene Urban|noise]
        [--size vga|720p|1080p] [--radius 2] [--plain]
        [--device cuda|cpu] [--smoke]

The counterpart of the JAX package's `tools/dump_offsets.py`, with its
flags, defaults and file: the DCN kernel's cost depends on the real
offset planes a checkpoint produces, which `bench_kernels --offsets`
then times. One forward of the checkpoint's model in float32
(dcn_max_offset `--radius`, warp_max_flow 16, `fuse_project` read off the
tree; the float32 kernels on the card, or their plain versions with
`--plain`) on one frame pair; each DCN's offset conv output is caught
(`ModulatedDeformConv.capture`) and written as

- `offset_l<i>` float16 (1, H, W, 18): the static and dynamic offset
  halves concatenated, (dy, dx) interleaved per tap, as the DCN reads them;
- `mask_l<i>` float16 (1, H, W, 9): the mask after the sigmoid.

It prints each layer's |dx| p99 (clamped to R) and the path written.

Frames (`--scene`): the pair frame10 / frame11 of a Middlebury val scene
(`data/processed/val/<scene>` in the repository), decoded by the port's
PNG codec and resized to `--size` (`ops.resize.resize_u8`: bilinear with
half-pixel centres, antialiased when it shrinks, rounded to uint8); or
`noise`, two uniform frames from `np.random.RandomState(1)`. The JAX tool
resizes with Pillow's BILINEAR, which computes the same filter in fixed
point: the uint8 frames can differ by a level where a value lies near a
rounding boundary. When it shrinks, Pillow's filter support widens with
the scale and torch's antialiased filter matches it only approximately.
`--smoke` writes 8x16 planes (the frame `bench_kernels --smoke` times),
on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from vfi_tpu_torch import native
from vfi_tpu_torch.infer.pair import resolve_device
from vfi_tpu_torch.ops.resize import resize_u8
from vfi_tpu_torch.tools import ROOT, build_model

VAL_DIR = os.path.join(ROOT, "data", "processed", "val")
SIZES = {"vga": (480, 640), "720p": (720, 1280), "1080p": (1080, 1920)}
# bench_kernels' smoke frame, so that `bench_kernels --smoke --offsets`
# reads a smoke dump.
SMOKE = (8, 16)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default="artifacts/emavfi_q2_best.npz")
    p.add_argument("--scene", default="Urban",
                   help="Middlebury val scene name, or 'noise'")
    p.add_argument("--size", default="720p", choices=list(SIZES))
    p.add_argument("--out", required=True)
    p.add_argument("--radius", type=int, default=2)
    p.add_argument("--plain", action="store_true",
                   help="the kernels' plain versions")
    p.add_argument("--device", default="cuda")
    p.add_argument("--smoke", action="store_true",
                   help="8x16 frames (runs on the CPU with --device cpu)")
    return p.parse_args(argv)


def load_pair(scene: str, h: int, w: int) -> tuple:
    """(f0, f1), each (1, h, w, 3) float32 in [0, 1]: a val scene's
    frames 10 and 11 resized to h x w, or `noise`."""
    if scene == "noise":
        rng = np.random.RandomState(1)
        return tuple(rng.uniform(size=(1, h, w, 3)).astype(np.float32)
                     for _ in range(2))
    frames = []
    for name in ("frame10.png", "frame11.png"):
        with open(os.path.join(VAL_DIR, scene, name), "rb") as f:
            img = native.decode_png_rgb(f.read())
        if img.shape[:2] != (h, w):
            img = resize_u8(img, h, w)
        frames.append(img[None].astype(np.float32) / 255.0)
    return tuple(frames)


@contextlib.contextmanager
def captured(model):
    """The raw offset conv outputs of the model's DCNs during the block,
    one list a DCN, in order."""
    dcns = [getattr(model, f"fusion_dcn{i}") for i in range(model.num_blocks)]
    raws = [[] for _ in dcns]
    for dcn, out in zip(dcns, raws):
        dcn.capture = out.append
    try:
        yield raws
    finally:
        for dcn in dcns:
            dcn.capture = None


def offset_planes(model, f0: torch.Tensor, f1: torch.Tensor) -> dict:
    """One forward; per DCN `offset_l<i>` (static and dynamic halves, (dy,
    dx) interleaved) and `mask_l<i>` (sigmoid) as float32 numpy arrays."""
    with torch.inference_mode(), captured(model) as raws:
        model(f0, f1)
    out = {}
    for li, (raw,) in enumerate(raws):
        o_s, m, o_d = torch.split(raw.float(), 9, dim=-1)
        out[f"offset_l{li}"] = torch.cat([o_s, o_d], dim=-1).cpu().numpy()
        out[f"mask_l{li}"] = torch.sigmoid(m).cpu().numpy()
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    h, w = SMOKE if args.smoke else SIZES[args.size]
    f0, f1 = (torch.from_numpy(f).to(dev) for f in load_pair(args.scene,
                                                               h, w))
    model = build_model(args.ckpt, dev, dcn_max_offset=args.radius,
                        warp_max_flow=16, use_kernels=not args.plain)
    planes = offset_planes(model, f0, f1)
    np.savez_compressed(args.out, **{k: v.astype(np.float16)
                                     for k, v in planes.items()})
    p99 = []
    for li in range(model.num_blocks):
        off = planes[f"offset_l{li}"].astype(np.float16).astype(np.float32)
        dx = np.clip(off[..., 1::2], -args.radius, args.radius)
        p99.append(float(np.percentile(np.abs(dx), 99)))
        print(f"l{li}: shape {off.shape} |dx| p99 {p99[-1]:.2f}")
    print(f"wrote {args.out}", flush=True)
    result = {"tool": "dump_offsets", "device": str(dev), "ckpt": args.ckpt,
              "scene": args.scene, "h": h, "w": w, "radius": args.radius,
              "plain": args.plain, "out": args.out, "dx_p99": p99}
    print(json.dumps(result), flush=True)
    return {**result, "planes": planes}


if __name__ == "__main__":
    main()
