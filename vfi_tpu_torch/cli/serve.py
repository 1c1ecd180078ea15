"""`python -m vfi_tpu_torch.cli.serve` — online interpolation serving over
HTTP, port of `vfi_tpu/cli/serve.py`, with the same flags plus
`--device`.

Stands up the micro-batched HTTP server (`vfi_tpu_torch.serve`) over a
`FrameInterpolator`. At the defaults (no `--dcn_max_offset`, no
`--warp_max_flow`) the model runs the exact DCN and warp in plain
PyTorch and launches no kernel; with the bounds it runs the bounded DCN
and warp kernels on the card. Frames go to the device as uint8 and
convert there unless `--f32_transfer` is given. `--use_pallas` and
`--dcn_tile_w` are accepted for parity and have no effect, as in the
eval CLI. Runs on the card (`--device cuda`, the default) or, when asked,
on the CPU (`--device cpu`). `--fp32` runs the model in float32: on the
card the kernels' float32 instances.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="EMAVFI online interpolation server (PyTorch / CUDA)")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=8,
                        help="device batch per launch; every launch is "
                             "padded to this so each (H, W) bucket launches "
                             "one shape")
    parser.add_argument("--max_delay_ms", type=float, default=5.0,
                        help="max time a request waits for batch-mates")
    parser.add_argument("--max_px_per_launch", type=int, default=5_000_000,
                        help="memory guard: shrink a bucket's launch batch "
                             "so batch*H*W stays within this pixel budget "
                             "(0 = uncapped); 5M px keeps 720p at batch 5 "
                             "and 1080p at batch 2")
    parser.add_argument("--no_pad_to_max", action="store_true",
                        help="launch partial batches at their real size")
    parser.add_argument("--request_timeout", type=float, default=120.0)
    parser.add_argument("--warmup", default=None,
                        help="comma-separated buckets to run once before "
                             "serving: HxW pair buckets (720x1280,1080x1920) "
                             "and/or N@HxW sequence shapes (8@720x1280 = "
                             "9-frame x-vfi-raw-seq requests)")
    parser.add_argument("--fp32", action="store_true",
                        help="float32 model (on the card the kernels' float32 instances)")
    parser.add_argument("--dcn_max_offset", type=int, default=None)
    parser.add_argument("--warp_max_flow", type=int, default=None)
    parser.add_argument("--use_pallas", action="store_true",
                        help="accepted for parity; no effect (the bounded "
                             "DCN and warp always run their CUDA kernels on "
                             "the card)")
    parser.add_argument("--dcn_tile_w", type=int, default=None,
                        help="accepted for parity; no effect (a TPU tiling "
                             "knob)")
    parser.add_argument("--flow_prior", action="store_true")
    parser.add_argument("--flow_model", default=None)
    parser.add_argument("--flow_prior_scale", type=float, default=0.5)
    parser.add_argument("--flow_mid_channels", type=int, default=32)
    parser.add_argument("--flow_levels", type=int, default=3)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--f32_transfer", action="store_true",
                        help="ship float32 frames to the device instead of "
                             "the default uint8 on-device conversion "
                             "(io_uint8 quarters host-to-device bytes)")
    parser.add_argument("--png_compress_level", type=int, default=1,
                        help="zlib level for response PNGs (0-9; default "
                             "1). Raw-RGB requests skip the codec entirely.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    return parser


def build_server(argv=None):
    """Parse the flags, build the engine and the server, and run the
    `--warmup` buckets. Returns the `InterpolationServer`, not started."""
    args = build_parser().parse_args(argv)

    from vfi_tpu_torch.cli.common import load_model_params
    from vfi_tpu_torch.infer.pair import FrameInterpolator
    from vfi_tpu_torch.serve import InterpolationServer

    params = load_model_params(args.model_path)
    flow_params = None
    if args.flow_prior:
        flow_path = args.flow_model or (
            args.model_path[:-4] if args.model_path.endswith(".npz")
            else args.model_path) + ".flow.npz"
        flow_params = load_model_params(flow_path)
    engine = FrameInterpolator(params, bf16=not args.fp32,
                               dcn_max_offset=args.dcn_max_offset,
                               warp_max_flow=args.warp_max_flow,
                               flow_params=flow_params,
                               flow_prior_scale=args.flow_prior_scale,
                               flow_mid_channels=args.flow_mid_channels,
                               flow_levels=args.flow_levels,
                               io_uint8=not args.f32_transfer,
                               device=args.device)
    server = InterpolationServer(engine, host=args.host, port=args.port,
                                 max_batch=args.max_batch,
                                 max_delay_ms=args.max_delay_ms,
                                 pad_to_max=not args.no_pad_to_max,
                                 request_timeout=args.request_timeout,
                                 verbose=args.verbose,
                                 png_compress_level=args.png_compress_level,
                                 max_px_per_launch=(args.max_px_per_launch
                                                    or None))
    if args.warmup:
        for spec in args.warmup.split(","):
            spec = spec.lower()
            if "@" in spec:  # sequence route: N@HxW = (N+1)-frame requests
                n, hw = spec.split("@")
                h, w = (int(v) for v in hw.split("x"))
                print(f"warmup: {int(n) + 1}-frame {h}x{w} sequence launches")
                server.warmup([(int(n) + 1, h, w)])
                continue
            h, w = (int(v) for v in spec.split("x"))
            b = server.batcher.launch_size((h, w))
            print(f"warmup: {h}x{w} bucket (batch {b})")
            server.warmup([(h, w)])
    return server


def main(argv=None) -> int:
    server = build_server(argv)
    print(f"serving on http://{server.host}:{server.port} "
          f"(POST /v1/interpolate, GET /healthz, GET /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
