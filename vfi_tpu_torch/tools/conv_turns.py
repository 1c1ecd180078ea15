"""Device time of the conv kernels of several checkouts, taking turns.

    python -m vfi_tpu_torch.tools.conv_turns --trees A,B,B,A
        [--shapes 64x64,128x64,64x32,6x64,64x27c] [--b 1] [--h 720]
        [--w 1280] [--launches 100] [--device cuda|cpu] [--smoke]

Each entry of `--trees` is the root of a checkout of this repository (for
example a parent commit unpacked with `git archive`, and the change). In
the order given, one Python process per entry imports that checkout's
`vfi_tpu_torch`, which builds its own kernels into its own `build/`, and
for each shape records `--launches` back-to-back launches between two
CUDA events after a warm-up: device time per launch, no synchronise
between launches. A shape `CinxCout` is a 3x3 conv + bias + ReLU through
`ops.cuda.conv2d`; `CinxCoutc` is a one-layer `conv_chain` without the
ReLU (the DCN blocks' offset conv). Inputs and weights come from a seeded
numpy generator, the same in every process. Give the trees in turns
(A, B, B, A) to cancel drift of the card's clocks.

Prints one line per (turn, shape); the last line is one JSON object with
every row and, per tree and shape, the median over that tree's turns.
`--device cpu --smoke` runs a 1x8x16 shape through the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

LAUNCHES = 100
SHAPES = "64x64,128x64,64x32,6x64,64x27c"

# Run in each checkout: its own package, the API every checkout with the
# port's conv wrappers shares.
CHILD = r"""
import json, sys
import numpy as np
import torch
args = json.loads(sys.argv[1])
sys.path.insert(0, args["tree"])
from vfi_tpu_torch.ops.cuda import conv2d, conv_chain
dev = torch.device(args["device"])
cuda = dev.type == "cuda"
if not cuda:
    torch.set_num_threads(1)
b, h, w, n = args["b"], args["h"], args["w"], args["launches"]
rows = []
for shape in args["shapes"]:
    chain = shape.endswith("c")
    cin, cout = (int(v) for v in shape.rstrip("c").split("x"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin), np.float32)).to(
        dev, torch.bfloat16)
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * 0.05
                           ).astype(np.float32)).to(dev)
    bs = torch.from_numpy(rng.standard_normal((cout,)).astype(np.float32)
                          ).to(dev)
    if chain:
        fn = lambda: conv_chain(x, [wt], [bs], (False,))
    else:
        fn = lambda: conv2d(x, wt, bs, True)
    for _ in range(3):
        fn()
    if cuda:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1) / n
    else:
        import time
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / n
    out = fn().float()
    rows.append({"shape": shape, "ms": ms,
                 "checksum": float(out.abs().mean())})
print(json.dumps(rows))
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", required=True,
                    help="comma list of checkout roots, in turn order")
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma list of CinxCout (conv2d + ReLU) or "
                         "CinxCoutc (one-layer conv_chain)")
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--launches", type=int, default=LAUNCHES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a 1x8x16 shape, 2 launches (the CPU with "
                         "--device cpu)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    b, h, w = (1, 8, 16) if args.smoke else (args.b, args.h, args.w)
    launches = 2 if args.smoke else args.launches
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    shapes = args.shapes.split(",")
    rows = []
    for turn, tree in enumerate(trees):
        child = {"tree": tree, "device": args.device, "b": b, "h": h,
                 "w": w, "launches": launches, "shapes": shapes}
        res = subprocess.run([sys.executable, "-c", CHILD, json.dumps(child)],
                             cwd=tree, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"conv_turns: {tree} failed:\n{res.stderr}")
        for row in json.loads(res.stdout.strip().splitlines()[-1]):
            row.update(turn=turn, tree=tree)
            rows.append(row)
            print(f"turn {turn} {tree}  {row['shape']:>8s}  "
                  f"{row['ms']:8.4f} ms", flush=True)
    medians = {tree: {s: float(np.median([r["ms"] for r in rows
                                          if r["tree"] == tree
                                          and r["shape"] == s]))
                      for s in shapes} for tree in dict.fromkeys(trees)}
    result = {"tool": "conv_turns", "device": args.device, "b": b, "h": h,
              "w": w, "launches": launches, "rows": rows,
              "median_ms": medians}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
