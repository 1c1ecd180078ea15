"""Clip frame-rate up-conversion, timed end to end: the counterpart of the
JAX package's `tools/video_demo.py`.

    python -m vfi_tpu_torch.tools.video_demo --model_path M.npz
        [--height 1080] [--width 1920] [--frames 24] [--fps 15]
        [--target_fps 60] [--flow_model F.npz] [--scale 1.0]
        [--batch_pairs 4] [--radius 2] [--dcn_tile_w N]
        [--workdir runs/video_demo] [--out_json F] [--device cuda|cpu]
        [--smoke]

Synthesizes a moving-texture clip at the requested size and rate with
OpenCV (the JAX tool's frames, bit for bit), runs `python -m
vfi_tpu_torch.cli.infer video` on it (recursive-midpoint up-conversion to
--target_fps at --scale, with the JAX tool's arguments: `--use_pallas`,
`--dcn_max_offset` --radius, `--warp_max_flow 16`, `--flow_prior
--flow_model` and `--dcn_tile_w` when given, and `--device`), and writes
ONE JSON file with the JAX tool's fields:

  {"resolution": "1920x1080", "in_frames": N, "in_fps": F,
   "out_frames": M, "output_fps": F', "interpolated_frames": K,
   "wall_s": S, "interpolated_frames_per_sec": K/S, "scale": s,
   "model_path": ..., "note": ...}

The wall clock covers the whole CLI run: model load, the kernels' build
where the checkout has none cached, decode, interpolation and encode. The default
--out_json is the port's own file (`artifacts/torch_video_upconv_demo.json`),
never one of the JAX package's records (`artifacts/video_upconv_*.json`).
Video files need cv2 (imported inside the functions that use it, as the
infer CLI's video I/O does); where it does not import, the tool cannot
run. `--smoke` runs a 168x176 clip of 3 frames (15 -> 60 fps: factor 3,
two bisection levels) on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from vfi_tpu_torch.tools import ROOT

# The JAX tool's moving block: 160 x 160 pixels, so a clip is wider and
# taller than that.
SMOKE = dict(height=168, width=176, frames=3, fps=15.0, target_fps=60.0,
             device="cpu")


def synthesize_clip(path: str, h: int, w: int, frames: int,
                    fps: float) -> None:
    """The JAX tool's clip: a drifting sinusoidal texture in B, noise
    rolled right in G and up in R, and a red block moving across it,
    `frames` frames at `fps` written with the mp4v codec."""
    import cv2

    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    out = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not out.isOpened():
        raise RuntimeError(f"cannot open VideoWriter for {path}")
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    for t in range(frames):
        base = (127 + 60 * np.sin(0.05 * (xx + 6.0 * t))
                + 40 * np.sin(0.08 * (yy - 4.0 * t)))
        frame = np.stack([base, np.roll(noise, 3 * t, axis=1),
                          np.roll(noise, -2 * t, axis=0)], axis=-1)
        bx = int((0.2 * w + 9.0 * t) % (w - 160))
        by = int((0.3 * h + 5.0 * t) % (h - 160))
        frame[by:by + 160, bx:bx + 160] = (255, 64, 64)
        out.write(np.clip(frame, 0, 255).astype(np.uint8))
    out.release()


def count_frames(path: str) -> tuple:
    """(frames, fps) of a video file, as its container reports them."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return n, fps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--fps", type=float, default=15.0)
    ap.add_argument("--target_fps", type=float, default=60.0)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--flow_model", default=None)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch_pairs", type=int, default=4)
    ap.add_argument("--radius", type=int, default=2,
                    help="dcn_max_offset (1 = the flagship)")
    ap.add_argument("--dcn_tile_w", type=int, default=None,
                    help="passed on to the infer CLI, which takes it for "
                         "parity with the JAX CLI and ignores it")
    ap.add_argument("--workdir", default="runs/video_demo")
    ap.add_argument("--out_json",
                    default="artifacts/torch_video_upconv_demo.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a 168x176 clip of 3 frames on the CPU")
    args = ap.parse_args(argv)
    if args.smoke:
        vars(args).update(SMOKE)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    workdir = os.path.join(ROOT, args.workdir)
    os.makedirs(workdir, exist_ok=True)
    src = os.path.join(workdir, f"in_{args.height}p.mp4")
    dst = os.path.join(workdir, f"out_{args.height}p.mp4")
    synthesize_clip(src, args.height, args.width, args.frames, args.fps)

    cmd = [sys.executable, "-m", "vfi_tpu_torch.cli.infer", "video",
           "--input_video", src, "--output_video", dst,
           "--model_path", args.model_path,
           "--target_fps", str(args.target_fps),
           "--scale", str(args.scale),
           "--batch_pairs", str(args.batch_pairs),
           "--use_pallas", "--dcn_max_offset", str(args.radius),
           "--warp_max_flow", "16", "--device", args.device]
    if args.flow_model:
        cmd += ["--flow_prior", "--flow_model", args.flow_model]
    if args.dcn_tile_w is not None:
        cmd += ["--dcn_tile_w", str(args.dcn_tile_w)]
    t0 = time.time()
    subprocess.run(cmd, check=True, cwd=ROOT)
    wall = time.time() - t0

    out_frames, out_fps = count_frames(dst)
    interpolated = out_frames - args.frames
    report = {
        "resolution": f"{args.width}x{args.height}",
        "in_frames": args.frames,
        "in_fps": args.fps,
        "out_frames": out_frames,
        "output_fps": out_fps,
        "interpolated_frames": interpolated,
        "wall_s": round(wall, 2),
        "interpolated_frames_per_sec": round(interpolated / wall, 3),
        "scale": args.scale,
        "model_path": args.model_path,
        "note": f"vfi_tpu_torch on --device {args.device}: end-to-end CLI "
                "wall clock incl. model load, the kernels' build where none "
                "is cached, and codec",
    }
    with open(os.path.join(ROOT, args.out_json), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
