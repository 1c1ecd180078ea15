"""`python -m vfi_tpu_torch.cli.eval` — Middlebury evaluation, port of
`vfi_tpu/cli/eval.py`, with the same flags, grouping and `--json` schema.

Two modes:
- PSNR/SSIM of the predicted middle frames over a triplet dataset at
  native resolution, per scene and as a mean over scenes
  (`--model_path`);
- flow endpoint error of a SimpleFlowNet against the Middlebury GT flows
  (`--flow_model` without `--flow_prior`).

Runs on the card (`--device cuda`, the default) or, when asked, on the CPU
through the plain PyTorch path (`--device cpu`). `--conv_kernel` picks
how the trunk convs run ("xla": plain convs, the JAX CLI's only setting;
"pallas": the conv-chain kernel). `--use_pallas` and `--dcn_tile_w` are
accepted for parity and have no effect: the bounded DCN and warp always
run their CUDA kernels on the card, and the tile width is a TPU knob.
`--fp32` runs the model (and the flow estimator) in float32: on the card
the kernels' float32 instances.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

import numpy as np
import torch

from vfi_tpu_torch.data.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                        TripletDataset, load_image)
from vfi_tpu_torch.utils.flo import endpoint_error, read_flo


def _find_frame(scene_dir: str, stem: str):
    for ext in (".png", ".jpg", ".jpeg"):
        p = os.path.join(scene_dir, stem + ext)
        if os.path.exists(p):
            return p
    return None


def _scene(path: str) -> str:
    return os.path.basename(os.path.dirname(path))


def evaluate_flow(flow_fn, frames_dir: str, gt_flow_dir: str,
                  pair=("frame10", "frame11")) -> dict:
    """Score a flow estimator against the bundled Middlebury GT flows
    (`<gt_flow_dir>/<scene>/flow10.flo`). For each GT scene with frames
    under `frames_dir/<scene>/`, predicts flow_fn(frame10, frame11) at the
    frames' resolution, rescales it to the GT grid (bilinear resize and
    per-component magnitude scaling), and reports the mean endpoint error
    over the valid GT pixels.

    flow_fn: (f0, f1) (1, H, W, 3) float32 [0, 1] arrays -> (1, H, W, 2)
      float32 flow tensor (dx, dy) in pixels, `warp(f1, flow) ~ f0`.
    Returns {"scenes": {name: epe}, "mean_epe": float}."""
    from vfi_tpu_torch.ops.resize import resize_bilinear

    results = {}
    for flo_path in sorted(glob.glob(os.path.join(gt_flow_dir, "*",
                                                  "flow10.flo"))):
        scene = _scene(flo_path)
        scene_dir = os.path.join(frames_dir, scene)
        f0p = _find_frame(scene_dir, pair[0])
        f1p = _find_frame(scene_dir, pair[1])
        if f0p is None or f1p is None:
            continue
        gt = read_flo(flo_path)
        pred = flow_fn(load_image(f0p)[None], load_image(f1p)[None]).float()
        gh, gw = gt.shape[:2]
        h, w = pred.shape[1:3]
        if (gh, gw) != (h, w):
            pred = resize_bilinear(pred, (gh, gw))
            pred = pred * torch.tensor([gw / w, gh / h], device=pred.device)
        results[scene] = endpoint_error(pred[0].cpu().numpy(), gt)
    if not results:
        # An empty sweep must not read as a perfect 0.0 EPE.
        raise FileNotFoundError(
            f"no (GT flow, frame pair) matches found under {gt_flow_dir!r} / "
            f"{frames_dir!r} — check the paths")
    mean = float(sum(results.values()) / len(results))
    return {"scenes": results, "mean_epe": mean}


def _flow_main(args) -> int:
    """Flow-EPE mode of the CLI."""
    from vfi_tpu_torch.cli.common import load_model_params
    from vfi_tpu_torch.infer.pair import resolve_device
    from vfi_tpu_torch.models.flownet import SimpleFlowNet
    from vfi_tpu_torch.utils.convert import params_from_jax

    dev = resolve_device(args.device)
    net = SimpleFlowNet(mid_channels=args.flow_mid_channels,
                        levels=args.flow_levels,
                        dtype=None if args.fp32 else torch.bfloat16)
    net.load_state_dict(params_from_jax(load_model_params(args.flow_model)))
    net.to(dev).eval()
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)

    @torch.inference_mode()
    def flow_fn(f0, f1):
        # the estimator trains on ImageNet-normalized frames
        f0n = (torch.from_numpy(f0).to(dev) - mean) / std
        f1n = (torch.from_numpy(f1).to(dev) - mean) / std
        return net(f0n, f1n)

    report = evaluate_flow(flow_fn, args.data_dir, args.gt_flow_dir)
    if args.json:
        print(json.dumps(report))
    else:
        for scene, epe in sorted(report["scenes"].items()):
            print(f"{scene:20s} EPE {epe:7.3f} px")
        print(f"{'MEAN':20s} EPE {report['mean_epe']:7.3f} px")
    return 0


def sweep(interp, data_dir: str, frame_interval: int = 1,
          batch_size: int = 4, load=None) -> tuple:
    """PSNR/SSIM of `interp.midpoints` over the triplets of `data_dir`.

    Triplets are grouped by frame shape so batches keep one shape; with
    auto_scale also by scene, so a batch's probe never decides one scene's
    route from another scene's flow. `load(path)` decodes a frame
    (default: `load_image`, each path decoded once).

    Returns (report, batches): `report` is the CLI's `--json` object;
    `batches` lists per batch its scene, size, auto_scale probe (or None)
    and whether it ran at half resolution."""
    if load is None:
        cache = {}

        def load(path):
            if path not in cache:
                cache[path] = load_image(path)
            return cache[path]

    auto = interp.auto_scale is not None
    ds = TripletDataset(data_dir, frame_interval)
    # Scenes with too few frames for a triplet (the bundled val Teddy has
    # two) are excluded, and the output says so.
    all_scenes = sorted(d for d in os.listdir(data_dir)
                        if os.path.isdir(os.path.join(data_dir, d)))
    covered = {_scene(t[0]) for t in ds.triplets}
    excluded = [s for s in all_scenes if s not in covered]

    per_scene = defaultdict(lambda: {"psnr": [], "ssim": [], "scaled": 0,
                                     "batches": 0})
    groups = defaultdict(list)
    for t in ds.triplets:
        key = load(t[0]).shape
        if auto:
            key = (_scene(t[0]), key)
        groups[key].append(t)

    from vfi_tpu_torch.utils.metrics import psnr, ssim

    batches = []
    for triplets in groups.values():
        for i in range(0, len(triplets), batch_size):
            chunk = triplets[i:i + batch_size]
            f0, gt, f1 = (np.stack([load(t[k]) for t in chunk])
                          for k in range(3))
            stats = interp.auto_scale_stats
            scaled_before, n_probes = stats["scaled"], len(stats["probes"])
            pred = interp.midpoints(f0, f1)
            routed = stats["scaled"] - scaled_before
            gt_t = torch.from_numpy(gt).to(pred.device)
            p = psnr(pred, gt_t).tolist()
            s = ssim(pred, gt_t).tolist()
            for k, t in enumerate(chunk):
                per_scene[_scene(t[0])]["psnr"].append(p[k])
                per_scene[_scene(t[0])]["ssim"].append(s[k])
            scene0 = _scene(chunk[0][0])
            per_scene[scene0]["scaled"] += routed
            per_scene[scene0]["batches"] += 1
            batches.append({"scene": scene0, "n": len(chunk),
                            "probe": (stats["probes"][n_probes]
                                      if len(stats["probes"]) > n_probes
                                      else None),
                            "scaled": bool(routed)})

    rows = {scene: {"psnr": float(np.mean(v["psnr"])),
                    "ssim": float(np.mean(v["ssim"])),
                    "n": len(v["psnr"]),
                    **({"auto_scaled": f'{v["scaled"]}/{v["batches"]}'}
                       if auto else {})}
            for scene, v in sorted(per_scene.items())}
    report = {"scenes": rows,
              "mean_psnr": float(np.mean([r["psnr"] for r in rows.values()])),
              "mean_ssim": float(np.mean([r["ssim"] for r in rows.values()])),
              "excluded_scenes": excluded}
    return report, batches


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="EMAVFI eval (PSNR/SSIM)")
    parser.add_argument("--data-dir", required=True,
                        help="scene-per-subdirectory dataset (Middlebury "
                             "layout)")
    parser.add_argument("--model_path", default=None,
                        help="EMAVFI params npz (required unless "
                             "--flow_model)")
    parser.add_argument("--frame_interval", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--fp32", action="store_true",
                        help="float32 model (on the card the kernels' float32 instances)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--dcn_max_offset", type=int, default=None,
                        help="bounded-offset DCN sampling radius (px)")
    parser.add_argument("--warp_max_flow", type=int, default=None,
                        help="bounded warp flow radius (px)")
    parser.add_argument("--use_pallas", action="store_true",
                        help="accepted for parity; no effect (the bounded "
                             "DCN and warp always run their CUDA kernels on "
                             "the card)")
    parser.add_argument("--dcn_tile_w", type=int, default=None,
                        help="accepted for parity; no effect (a TPU tiling "
                             "knob)")
    parser.add_argument("--conv_kernel", choices=("xla", "pallas"),
                        default="xla",
                        help="trunk convs as plain convs (xla) or through "
                             "the conv-chain kernel (pallas)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    parser.add_argument("--cascade_levels", type=int, default=1,
                        help="EMAVFI self-cascade depth: >1 runs the motion "
                             "stages coarse-to-fine (shared weights) — use "
                             "on checkpoints fine-tuned with the same depth")
    parser.add_argument("--tta", action="store_true",
                        help="average 4 symmetry-transformed forwards "
                             "(identity/hflip/vflip/temporal-swap)")
    parser.add_argument("--flow_model", default=None,
                        help="SimpleFlowNet params npz; without --flow_prior "
                             "evaluates flow EPE against --gt_flow_dir "
                             "instead of PSNR/SSIM")
    parser.add_argument("--gt_flow_dir",
                        default="data/processed/other-gt-flow",
                        help="Middlebury GT .flo directory (scene subdirs)")
    parser.add_argument("--flow_mid_channels", type=int, default=32)
    parser.add_argument("--flow_levels", type=int, default=3)
    parser.add_argument("--flow_prior", action="store_true",
                        help="pre-warp frame1 halfway along the SimpleFlowNet"
                             " flow before the model (checkpoint must be "
                             "TRAINED with flow_prior). Loads <model_path "
                             "minus .npz>.flow.npz unless --flow_model is "
                             "given")
    parser.add_argument("--flow_prior_scale", type=float, default=0.5)
    parser.add_argument("--auto_scale", type=float, default=None,
                        metavar="PIXELS",
                        help="when the flow estimator's p95 motion magnitude "
                             "exceeds this many pixels, infer at half "
                             "resolution and upsample (needs --flow_prior)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.auto_scale is not None and not args.flow_prior:
        parser.error("--auto_scale requires --flow_prior (the flow "
                     "estimator provides the motion-magnitude probe)")
    if args.flow_model and not args.flow_prior:
        return _flow_main(args)
    if not args.model_path:
        parser.error("--model_path is required (unless evaluating a flow "
                     "estimator via --flow_model)")

    from vfi_tpu_torch.cli.common import load_model_params
    from vfi_tpu_torch.infer.pair import FrameInterpolator

    params = load_model_params(args.model_path)
    flow_params = None
    if args.flow_prior:
        flow_path = args.flow_model or (
            args.model_path[:-4] if args.model_path.endswith(".npz")
            else args.model_path) + ".flow.npz"
        flow_params = load_model_params(flow_path)
    interp = FrameInterpolator(params, bf16=not args.fp32,
                               dcn_max_offset=args.dcn_max_offset,
                               warp_max_flow=args.warp_max_flow,
                               conv_kernel=args.conv_kernel,
                               cascade_levels=args.cascade_levels,
                               tta=args.tta,
                               flow_params=flow_params,
                               flow_prior_scale=args.flow_prior_scale,
                               flow_mid_channels=args.flow_mid_channels,
                               flow_levels=args.flow_levels,
                               auto_scale=args.auto_scale,
                               device=args.device)
    report, _ = sweep(interp, args.data_dir, args.frame_interval,
                      args.batch_size)
    if args.json:
        print(json.dumps(report))
    else:
        rows = report["scenes"]
        for scene, r in rows.items():
            print(f"{scene:20s} PSNR {r['psnr']:6.2f} dB  SSIM "
                  f"{r['ssim']:.4f}  (n={r['n']})")
        n_all = len(rows) + len(report["excluded_scenes"])
        print(f"{'MEAN':20s} PSNR {report['mean_psnr']:6.2f} dB  SSIM "
              f"{report['mean_ssim']:.4f} ({len(rows)}/{n_all} scenes)")
        if report["excluded_scenes"]:
            print(f"excluded (no triplet at interval {args.frame_interval}):"
                  f" {', '.join(report['excluded_scenes'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
