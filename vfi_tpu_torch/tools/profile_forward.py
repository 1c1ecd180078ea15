"""Device time of the EMAVFI forward by op and by category, on the card.

    python -m vfi_tpu_torch.tools.profile_forward [--iters 4] [--b 4]
        [--h 720] [--w 1280] [--ckpt ckpt.npz] [--radius 2]
        [--conv_kernel xla|pallas] [--top 25] [--keep DIR] [--plain]
        [--engine [--cascade_levels 2]] [--device cuda|cpu] [--smoke]

The counterpart of the JAX package's `tools/profile_forward.py`. It
chains `--iters` forwards of the model in bf16 (dcn_max_offset `--radius`,
warp_max_flow 16, no cascade, no flow prior) at `--b` x `--h` x `--w`, each
on the output of the one before (x_{k+1} = model(x_k, f1)), once to warm
up and once under torch.profiler (`utils/profiling.device_profile`), and
prints:

- the total device op time and ms a frame (b x iters frames);
- device time by category, summed (overlapping ops count twice): the
  port's kernels, convolution (cuDNN), gemm, elementwise, reduce, layout
  (copy, memset, cat, transpose), collectives, other;
- the timeline attribution: each category's interval union, the overlap
  between categories and the device's idle gaps, which sum to the trace's
  wall span;
- the top `--top` ops by device time;
- device ops and kernel-wrapper launches a frame, and the host wall;
- the program's spans (`vfi.*`, `utils.profiling.span_table`): a row a
  span with its count, host ms (inclusive and self), the device ms and
  ops launched inside it (inclusive and self) and the ms inside it in
  which no kernel ran.

`--engine` profiles `--iters` calls of the inference engine
(`FrameInterpolator.midpoints`) instead, each on `--b` uint8 pairs from
page-locked host memory on the card, with `io_uint8`, the flow prior of
the checkpoint's `.flow.npz` where there is one and `--cascade_levels`
(needs `--ckpt`): the engine's spans (call, launch, upload, forward,
output) above the model's. The engine warms up on one pair less (or
more), so that no graph of the profiled call's shape is captured before
it: the profiled calls run eager, each stage in its span (the engine
never captures a CUDA graph under a profiler). On the card one more call
then captures the launches' graphs, and `--iters` steady calls, which
replay them (`vfi.replay`; the stages record no span there), are
profiled too: their span table is printed after the first's and is the
result's `replay`.

The last line is one JSON object with all of it. With `--ckpt` the model
has the checkpoint's weights and topology (`fuse_project` read off the
tree): the trained offsets' regime; without, the JAX model's defaults at
random. `--plain` runs the kernels' plain versions instead of the kernels
(the JAX tool's `--no-pallas`). `--keep DIR` also writes the Chrome trace,
`DIR/trace.json`. The JAX tool's `--dcn_kernel` and `--tile_w` chose TPU
kernel generations and tilings; here `ops.cuda.dcn_plan` picks the DCN's
design, and both are refused. `--smoke` runs a 1x16x32 frame pair, one
forward, on the CPU with `--device cpu` (the device ops are then the CPU's
aten ops).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from vfi_tpu_torch.infer.pair import resolve_device
from vfi_tpu_torch.ops.cuda import launch_counts
from vfi_tpu_torch.tools import build_model, card_line, uniform_frames
from vfi_tpu_torch.utils.profiling import device_profile

SMOKE = dict(b=1, h=16, w=32, iters=1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--b", type=int, default=4)
    p.add_argument("--h", type=int, default=720)
    p.add_argument("--w", type=int, default=1280)
    p.add_argument("--plain", action="store_true",
                   help="the kernels' plain versions (JAX: --no-pallas)")
    p.add_argument("--ckpt", default=None,
                   help="trained checkpoint npz (trained-offset regime; "
                        "fuse_project topology read off the tree)")
    p.add_argument("--tile_w", type=int, default=None,
                   help="refused: a TPU tiling (dcn_plan picks the design)")
    p.add_argument("--dcn_kernel", default=None,
                   help="refused: a TPU kernel generation (dcn_plan picks "
                        "the design)")
    p.add_argument("--radius", type=int, default=2,
                   help="dcn_max_offset (1 = the flagship)")
    p.add_argument("--conv_kernel", default="xla", choices=("xla", "pallas"))
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--keep", default=None,
                   help="also write the Chrome trace to DIR/trace.json")
    p.add_argument("--engine", action="store_true",
                   help="profile FrameInterpolator.midpoints calls on uint8 "
                        "pairs (needs --ckpt)")
    p.add_argument("--cascade_levels", type=int, default=1,
                   help="the model's self-cascade levels")
    p.add_argument("--device", default="cuda")
    p.add_argument("--smoke", action="store_true",
                   help="a 1x16x32 pair, one forward (runs on the CPU with "
                        "--device cpu)")
    args = p.parse_args(argv)
    for flag in ("tile_w", "dcn_kernel"):
        if getattr(args, flag) is not None:
            raise SystemExit(
                f"--{flag} chose a TPU kernel's generation or tiling; the "
                f"port has one DCN kernel, whose design and tiles "
                f"ops.cuda.dcn_plan picks from the shape")
    if args.engine and args.ckpt is None:
        raise SystemExit("--engine needs --ckpt")
    if args.smoke:
        vars(args).update(SMOKE)
    return args


def engine_call(args, dev: torch.device):
    """The engine over `--ckpt` (and its `.flow.npz` flow prior where
    there is one) and `--b` uint8 pairs, page-locked on the card: a
    `midpoints` call on them, and a warm-up call on one pair less (or,
    for one pair, two), another launch shape."""
    from vfi_tpu_torch.infer.pair import FrameInterpolator
    from vfi_tpu_torch.utils.convert import load_params_npz

    flow = args.ckpt[:-len(".npz")] + ".flow.npz"
    engine = FrameInterpolator(
        load_params_npz(args.ckpt), device=dev, io_uint8=True,
        flow_params=(load_params_npz(flow) if os.path.exists(flow)
                     else None),
        dcn_max_offset=args.radius, warp_max_flow=16,
        cascade_levels=args.cascade_levels, conv_kernel=args.conv_kernel,
        use_kernels=not args.plain)
    f0, f1 = (torch.from_numpy((x.cpu().numpy() * 255).astype(np.uint8))
              for x in uniform_frames(args.b, args.h, args.w,
                                      torch.device("cpu")))
    if dev.type == "cuda":
        f0, f1 = f0.pin_memory(), f1.pin_memory()
    w0, w1 = (x[1:] if args.b > 1 else torch.cat([x, x]) for x in (f0, f1))
    return (lambda: engine.midpoints(f0, f1),
            lambda: engine.midpoints(w0, w1))


def print_spans(prof: dict) -> None:
    """The span table, a row a `vfi.*` span."""
    print("\nspans (ms; host incl / self, device incl / self, ops incl / "
          "self, no kernel running inside):")
    for name, r in prof["spans"].items():
        print(f"  {name:16s} x{r['count']:<3d} {r['host_ms']:9.3f} "
              f"{r['host_self_ms']:9.3f}  {r['device_ms']:9.3f} "
              f"{r['device_self_ms']:9.3f}  {r['ops']:6d} {r['ops_self']:6d}"
              f"  {r['idle_ms']:9.3f}")
    print(f"  outermost spans {prof['span_roots_ms']:9.3f} ms host; device "
          f"ms outside every span {prof['span_unattributed_ms']:.3f}; ops "
          f"before their span {prof['ops_before_span']}", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.engine:
        call, warm = engine_call(args, dev)

        def chain():
            for _ in range(args.iters):
                out = call()
            return out
    else:
        warm = None
        model = build_model(args.ckpt, dev, dtype=torch.bfloat16,
                            dcn_max_offset=args.radius, warp_max_flow=16,
                            conv_kernel=args.conv_kernel,
                            cascade_levels=args.cascade_levels,
                            use_kernels=not args.plain)
        f0, f1 = uniform_frames(args.b, args.h, args.w, dev)

        def chain():
            x = f0
            for _ in range(args.iters):
                x = model(x, f1)
            return x

    replay = None
    with torch.inference_mode():
        (warm or chain)()                        # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = launch_counts()
        prof = device_profile(chain, dev, log_dir=args.keep, top=args.top)
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        if warm is not None and dev.type == "cuda":
            call()                               # captures the graphs
            replay = device_profile(chain, dev, top=args.top)
    n = args.b * args.iters
    card = card_line(dev)
    print(f"{card}  b={args.b} {args.h}x{args.w} iters="
          f"{args.iters} R={args.radius} conv_kernel={args.conv_kernel}"
          f" cascade={args.cascade_levels}{' engine' if args.engine else ''}"
          f"{' plain' if args.plain else ''}", flush=True)
    total = prof["device_kernel_ms"]
    print(f"\ntotal device op time: {total:.3f} ms ({total / n:.3f} "
          f"ms/frame over {n} frames)")
    print("\nby category (ms, ms/frame; SUMMED durations -- overlapping "
          "ops count twice):")
    for cat, ms in sorted(prof["category_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {cat:18s} {ms:9.3f}  {ms / n:7.3f}")
    span = prof["trace_span_ms"]
    print("\nTIMELINE attribution (interval union -- rows sum to wall):")
    print(f"  trace wall span     {span:9.3f}  {span / n:7.3f}")
    for cat, ms in sorted(prof["timeline_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {cat:18s} {ms:9.3f}  {ms / n:7.3f}")
    ov = prof["cross_category_overlap_ms"]
    print(f"  cross-cat overlap  {-ov:9.3f}  {-ov / n:7.3f}")
    print(f"  device idle gaps    {prof['idle_ms']:9.3f}  "
          f"{prof['idle_ms'] / n:7.3f}")
    print(f"\ntop {args.top} ops (ms, ms/frame):")
    for name, ms in prof["top_kernels_ms"]:
        print(f"  {name:48.48s} {ms:9.3f}  {ms / n:7.3f}")
    print(f"\ndevice ops/frame {prof['kernel_launches'] / n:.1f}  kernel "
          f"wrapper launches/frame {sum(counts.values()) / n:.2f}  host "
          f"wall {prof['wall_ms']:.3f} ms ({prof['wall_ms'] / n:.3f} "
          f"ms/frame)", flush=True)
    print_spans(prof)
    if replay is not None:
        print(f"\nsteady calls, replayed: device ops/frame "
              f"{replay['kernel_launches'] / n:.1f}, device idle "
              f"{replay['idle_ms']:.3f} ms, host wall {replay['wall_ms']:.3f}"
              f" ms ({replay['wall_ms'] / n:.3f} ms/frame)")
        print_spans(replay)
    result = {"tool": "profile_forward", "card": card,
              "b": args.b, "h": args.h, "w": args.w, "iters": args.iters,
              "frames": n, "radius": args.radius, "ckpt": args.ckpt,
              "conv_kernel": args.conv_kernel, "plain": args.plain,
              "engine": args.engine, "cascade_levels": args.cascade_levels,
              "launches": counts, **prof, "replay": replay}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
