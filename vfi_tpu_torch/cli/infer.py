"""`python -m vfi_tpu_torch.cli.infer {two-frame,video,videos}` — the
interpolation CLI, port of `vfi_tpu/cli/infer.py`, with the same flags
plus `--device` on every subcommand.

- `two-frame`: the midpoint of two PNG images (decoded and written by the
  port's codec, `vfi_tpu_torch.native`; other formats raise), `--size H
  W` resizing as Pillow's BILINEAR (`ops.resize.resize_u8`), the output
  truncated to uint8 as the JAX CLI writes it;
- `video`: frame-rate up-conversion of one video (`infer.video`);
- `videos`: several clips at once, their pairs coalescing in one shared
  micro-batcher (`infer.multi`).

`video` and `videos` read and write files with OpenCV (cv2). Runs on the
card (`--device cuda`, the default) or, when asked, on the CPU
(`--device cpu`). `--fp32` runs the model in float32: on the card the
kernels' float32 instances (the TF32 flags of `torch.backends`, left as
they are, reach only the cuDNN convs outside the kernels).
`--use_pallas`, `--dcn_kernel` and `--dcn_tile_w` are accepted for parity
and have no effect, as in the eval and serve CLIs.

`--spatial N` > 1 shards the frame height over N ranks, one process and
one card each (NCCL; gloo on the CPU with `--device cpu`), through the
exact halo pipeline (`parallel.spatial`; it needs `--dcn_max_offset` and
`--warp_max_flow`). Fewer cards than N is an error. As in the JAX CLI the
cards left form the data axis: D = cards // N spatial groups of N ranks
(one on the CPU), each taking its share of a batch. Rank 0 reads and
writes; the frames reach the other ranks by `broadcast`.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="EMAVFI inference (PyTorch / CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    two = sub.add_parser("two-frame",
                         help="interpolate the midpoint of two PNG images")
    two.add_argument("--frame0", required=True)
    two.add_argument("--frame1", required=True)
    two.add_argument("--output", required=True, help="a .png path")
    two.add_argument("--model_path", required=True)
    two.add_argument("--size", type=int, nargs=2, default=None,
                     metavar=("H", "W"), help="resize inputs (default: native)")
    two.add_argument("--fp32", action="store_true",
                     help="float32 model (on the card the kernels' float32 instances)")

    multi = sub.add_parser(
        "videos", help="multi-clip up-conversion: pairs from all clips "
                       "coalesce into shared launches")
    multi.add_argument("--inputs", nargs="+", required=True)
    multi.add_argument("--outputs", nargs="+", required=True)
    multi.add_argument("--model_path", required=True)
    multi.add_argument("--target_fps", type=float, default=None)
    multi.add_argument("--max_interpolation_factor", type=int, default=4)
    multi.add_argument("--frame_interval", type=int, default=1)
    multi.add_argument("--codec", default="mp4v")
    multi.add_argument("--scale", type=float, default=0.5)
    multi.add_argument("--batch_pairs", type=int, default=8)
    multi.add_argument("--max_delay_ms", type=float, default=50.0,
                       help="max wait for cross-clip batch-mates")
    multi.add_argument("--fp32", action="store_true")
    multi.add_argument("--reference-compat", action="store_true")

    vid = sub.add_parser("video", help="frame-rate up-conversion of a video")
    vid.add_argument("--input_video", required=True)
    vid.add_argument("--output_video", required=True)
    vid.add_argument("--model_path", required=True)
    vid.add_argument("--target_fps", type=float, default=None)
    vid.add_argument("--max_interpolation_factor", type=int, default=4)
    vid.add_argument("--frame_interval", type=int, default=1)
    vid.add_argument("--codec", default="mp4v")
    vid.add_argument("--scale", type=float, default=0.5)
    vid.add_argument("--bitrate", default=None,
                     help="accepted for reference-CLI compatibility; unused "
                          "(the reference never used it either)")
    vid.add_argument("--batch_pairs", type=int, default=8)
    vid.add_argument("--fp32", action="store_true")
    vid.add_argument("--reference-compat", action="store_true",
                     help="reproduce the reference CLI's output quirks "
                          "(BGR stats, trailing originals, duplicated "
                          "midpoints)")
    for p in (two, vid, multi):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu (the plain PyTorch path)")
        p.add_argument("--dcn_max_offset", type=int, default=None,
                       help="bounded DCN sampling radius (px); none: the "
                            "exact DCN")
        p.add_argument("--warp_max_flow", type=int, default=None,
                       help="bounded warp flow radius (px)")
        p.add_argument("--use_pallas", action="store_true",
                       help="accepted for parity; no effect (the bounded "
                            "DCN and warp always run their CUDA kernels on "
                            "the card)")
        p.add_argument("--dcn_kernel", default="v4", choices=("v4", "v5"),
                       help="accepted for parity; no effect (a TPU kernel "
                            "generation)")
        p.add_argument("--conv_kernel", default="xla",
                       choices=("xla", "pallas"),
                       help="conv trunk: 'xla' plain convs, 'pallas' the "
                            "conv-chain kernels")
        p.add_argument("--dcn_tile_w", type=int, default=None,
                       help="accepted for parity; no effect (a TPU tiling "
                            "knob)")
        p.add_argument("--max_px_per_launch", type=int, default=None,
                       help="engine memory guard: split batches past this "
                            "many pixels into sequential launches (0 "
                            "disables; default 8M, 4M with the flow prior, "
                            "halved for TTA)")
        p.add_argument("--cascade_levels", type=int, default=1,
                       help="EMAVFI self-cascade depth (checkpoints "
                            "fine-tuned with the same depth)")
        p.add_argument("--spatial", type=int, default=1,
                       help="shard frame height over this many ranks, one "
                            "card each (the exact halo pipeline; needs the "
                            "bounded DCN and warp)")
        p.add_argument("--flow_prior", action="store_true",
                       help="pre-warp frame1 halfway along the SimpleFlowNet "
                            "flow; loads <model_path minus .npz>.flow.npz "
                            "unless --flow_model is given")
        p.add_argument("--flow_model", default=None,
                       help="SimpleFlowNet params npz for --flow_prior")
        p.add_argument("--flow_prior_scale", type=float, default=0.5)
        p.add_argument("--flow_mid_channels", type=int, default=32)
        p.add_argument("--flow_levels", type=int, default=3)
        p.add_argument("--tta", action="store_true",
                       help="average 4 symmetry-transformed forwards")
        p.add_argument("--auto_scale", type=float, default=None,
                       metavar="PIXELS",
                       help="infer at half resolution when the flow "
                            "estimator's p95 motion exceeds this many "
                            "pixels (needs --flow_prior)")
    return parser


def _read_png(path: str, size) -> np.ndarray:
    """A PNG file -> (1, H, W, 3) float32 [0, 1], resized to `size` = (H,
    W) as Pillow's BILINEAR where given."""
    from vfi_tpu_torch import native
    from vfi_tpu_torch.ops.resize import resize_u8

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != native.PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file; two-frame reads PNG "
                         f"images only")
    img = native.decode_png_rgb(data)
    if size:
        img = resize_u8(img, size[0], size[1])
    return img.astype(np.float32)[None] / 255.0


def build_engine(args, **kw):
    """The FrameInterpolator the flags ask for."""
    from vfi_tpu_torch.cli.common import load_model_params
    from vfi_tpu_torch.infer.pair import FrameInterpolator

    params = load_model_params(args.model_path)
    flow_params = None
    if args.flow_prior:
        flow_path = args.flow_model or (
            args.model_path[:-4] if args.model_path.endswith(".npz")
            else args.model_path) + ".flow.npz"
        flow_params = load_model_params(flow_path)
    return FrameInterpolator(
        params, bf16=not args.fp32, dcn_max_offset=args.dcn_max_offset,
        warp_max_flow=args.warp_max_flow, conv_kernel=args.conv_kernel,
        cascade_levels=args.cascade_levels,
        max_px_per_launch=("auto" if args.max_px_per_launch is None
                           else args.max_px_per_launch or None),
        flow_params=flow_params, flow_prior_scale=args.flow_prior_scale,
        flow_mid_channels=args.flow_mid_channels,
        flow_levels=args.flow_levels, tta=args.tta,
        auto_scale=args.auto_scale, **{"device": args.device, **kw})


def spatial_ranks(args) -> int:
    """The ranks of a `--spatial` run: N a data row, a row a group of N
    visible cards (one row on the CPU); raises when the cards are fewer
    than N."""
    import torch

    from vfi_tpu_torch.infer.pair import resolve_device

    from vfi_tpu_torch.parallel import make_mesh

    if args.spatial < 1:
        raise ValueError(f"--spatial must be >= 1, got {args.spatial}")
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.spatial > 1:
        cards = torch.cuda.device_count()
        if dev.index is not None:
            raise ValueError(f"--device {args.device}: --spatial takes "
                             "cards 0..n-1 (one a rank); pass --device cuda")
        if cards < args.spatial:
            raise ValueError(f"--spatial {args.spatial} needs "
                             f"{args.spatial} cards, {cards} visible")
        mesh = make_mesh(data=-1, spatial=args.spatial)
        return mesh.shape["data"] * args.spatial
    return args.spatial


def _spatial_rank(rank: int, world: int, port: int, argv) -> None:
    """One rank of a `--spatial` run (rank = data row * N + band): rank 0
    runs the subcommand, the others serve its engine calls."""
    import torch
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    cuda = args.device != "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        n = args.spatial
        rows = [dist.new_group(list(range(d * n, (d + 1) * n)))
                for d in range(world // n)]
        cols = [dist.new_group(list(range(j, world, n))) for j in range(n)]
        # (`video` hands reference_compat to the engine, as below)
        engine = build_engine(args, spatial=True, broadcast_inputs=True,
                              spatial_group=rows[rank // n],
                              data_group=cols[rank % n] if world > n
                              else None,
                              device=f"cuda:{rank}" if cuda else "cpu",
                              reference_compat=args.cmd == "video"
                              and args.reference_compat)
        if rank == 0:
            try:
                _run(args, engine)
            finally:
                engine.release()
        else:
            engine.follow()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if args.auto_scale is not None:
        if args.cmd == "videos":
            # the batcher mixes clips in one launch, whose one probe would
            # route a clip's frames by another clip's motion
            parser.error("--auto_scale is not supported with `videos` "
                         "(cross-clip batches share one motion probe); "
                         "run clips separately with `video`")
        if not args.flow_prior:
            parser.error("--auto_scale requires --flow_prior")
    if args.cmd == "two-frame" and not args.output.lower().endswith(".png"):
        raise ValueError(f"{args.output}: two-frame writes PNG files only")
    world = spatial_ranks(args)
    if world > 1:
        import torch.multiprocessing as mp

        from vfi_tpu_torch.cli.common import free_port

        argv = list(argv) if argv is not None else sys.argv[1:]
        mp.spawn(_spatial_rank, args=(world, free_port(), argv),
                 nprocs=world, join=True)
        return 0
    return _run(args, None)


def _run(args, engine) -> int:
    """The subcommand, on `engine` (None: build the flags' engine)."""
    if args.cmd == "two-frame":
        from vfi_tpu_torch import native

        f0 = _read_png(args.frame0, args.size)
        f1 = _read_png(args.frame1, args.size)
        engine = engine or build_engine(args)
        mid = engine.midpoints(f0, f1)[0].float().cpu().numpy()
        png = native.encode_png_rgb(
            (np.clip(mid, 0, 1) * 255).astype(np.uint8))
        with open(args.output, "wb") as f:
            f.write(png)
        print(f"wrote {args.output}")
        return 0

    if args.cmd == "videos":
        from vfi_tpu_torch.infer.multi import interpolate_videos

        all_stats = interpolate_videos(
            args.inputs, args.outputs, engine or build_engine(args),
            target_fps=args.target_fps,
            max_interpolation_factor=args.max_interpolation_factor,
            frame_interval=args.frame_interval, codec=args.codec,
            scale=args.scale, batch_pairs=args.batch_pairs,
            reference_compat=args.reference_compat,
            max_delay_ms=args.max_delay_ms)
        for inp, st in zip(args.inputs, all_stats):
            print(inp, {k: v for k, v in st.items() if k != "batcher"})
        print("batching:", all_stats[0]["batcher"] if all_stats else {})
        return 0

    from vfi_tpu_torch.infer.video import interpolate_video

    stats = interpolate_video(
        args.input_video, args.output_video,
        engine or build_engine(args, reference_compat=args.reference_compat),
        target_fps=args.target_fps,
        max_interpolation_factor=args.max_interpolation_factor,
        frame_interval=args.frame_interval, codec=args.codec,
        scale=args.scale, batch_pairs=args.batch_pairs,
        reference_compat=args.reference_compat)
    print(stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
