"""The inference cost of the flow prior against the plain forward.

    python -m vfi_tpu_torch.tools.bench_flowprior [--b 4] [--h 720]
        [--w 1280] [--iters 10] [--plain] [--device cuda|cpu] [--smoke]

The counterpart of the JAX package's `tools/bench_flowprior.py`. The flow
prior (models/prior.py) adds a SimpleFlowNet pyramid pass and one exact
bilinear pre-warp in front of the main model; this prices it on the
`emavfi_q3ft_best` checkpoint and its `.flow.npz` (bf16, dcn_max_offset 2,
warp_max_flow 16, prior scale 0.5; `fuse_project` read off the tree):
`--iters` chained forwards (x_{k+1} = forward(x_k, f1)) at `--b` x `--h` x
`--w` for each mode, the two chains timed in turns
(`tools.time_interleaved`: CUDA events, the median of ROUNDS rounds after
two warm-ups). Prints the card's name and power limit, then the JAX
tool's two JSON lines, `{"mode": "plain", "fps"}` and `{"mode":
"flow_prior", "fps", "overhead_pct"}` (frames/s = b x iters over a chain's
median). `--plain` runs the kernels' plain versions (the JAX tool's
`--no_pallas`). `--smoke` runs a 1x16x32 pair, one forward a chain, on
the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from vfi_tpu_torch.infer.pair import resolve_device
from vfi_tpu_torch.models import SimpleFlowNet, prior_prewarp
from vfi_tpu_torch.tools import (ROOT, build_model, card_line,
                                 time_interleaved, uniform_frames)
from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax

CKPT = os.path.join(ROOT, "artifacts", "emavfi_q3ft_best")
# Timed rounds of the two chains (the JAX tool took the best of three).
ROUNDS = 3
SMOKE = dict(b=1, h=16, w=32, iters=1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--plain", action="store_true",
                    help="the kernels' plain versions (JAX: --no_pallas)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a 1x16x32 pair, one forward (runs on the CPU with "
                         "--device cpu)")
    args = ap.parse_args(argv)
    if args.smoke:
        vars(args).update(SMOKE)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model = build_model(CKPT + ".npz", dev, dtype=torch.bfloat16,
                        dcn_max_offset=2, warp_max_flow=16,
                        use_kernels=not args.plain)
    flow = SimpleFlowNet(dtype=torch.bfloat16)
    flow.load_state_dict(params_from_jax(load_params_npz(CKPT
                                                         + ".flow.npz")))
    flow.to(dev).eval()
    f0, f1 = uniform_frames(args.b, args.h, args.w, dev)

    def prior_fwd(a, b):
        pre, _ = prior_prewarp(flow, a, b, scale=0.5)
        return model(a, pre)

    def chain(fwd):
        def run():
            x = f0
            for _ in range(args.iters):
                x = fwd(x, f1)
            return x
        return run

    with torch.inference_mode():
        ms = time_interleaved({"plain": chain(model),
                               "flow_prior": chain(prior_fwd)}, ROUNDS, dev)
    frames = args.b * args.iters
    plain, prior = (frames / (ms[k] / 1e3) for k in ("plain", "flow_prior"))
    card = card_line(dev)
    print(card, flush=True)
    lines = [{"mode": "plain", "fps": plain},
             {"mode": "flow_prior", "fps": prior,
              "overhead_pct": 100 * (plain / prior - 1)}]
    for line in lines:
        print(json.dumps(line), flush=True)
    return {"tool": "bench_flowprior", "device": str(dev),
            "card": card, "b": args.b, "h": args.h, "w": args.w,
            "iters": args.iters, "rounds": ROUNDS, "chain_ms": ms,
            "plain_fps": plain, "flow_prior_fps": prior,
            "overhead_pct": lines[1]["overhead_pct"]}


if __name__ == "__main__":
    main()
