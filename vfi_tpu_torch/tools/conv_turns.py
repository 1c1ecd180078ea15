"""Device time of the port's kernels in several checkouts, taking turns.

    python -m vfi_tpu_torch.tools.conv_turns --trees A,B,B,A
        [--shapes 64x64,128x64,64x32,6x64,64x27c,dcn64r1,dcn128r4,warp64r16,
                  chain_feat,chain_motion:fused,chain_rec:layers,chain_feat:fused:f32,
                  ...]
        [--b 1] [--h 720] [--w 1280] [--launches 100] [--device cuda|cpu]
        [--smoke]

Each entry of `--trees` is the root of a checkout of this repository (for
example a parent commit unpacked with `git archive`, and the change). In
the order given, one Python process per entry imports that checkout's
`vfi_tpu_torch`, which builds its own kernels into its own `build/`, and
for each shape records `--launches` back-to-back launches between two
CUDA events after a warm-up: device time per launch, no synchronise
between launches. The card first spins (`torch.cuda._sleep`) until every
launch is queued, so a launch shorter than its host path is timed on the
device too. Shapes:

- `CinxCout`: a 3x3 conv + bias + ReLU through `ops.cuda.conv2d`;
- `CinxCoutc`: a one-layer `conv_chain` without the ReLU (the DCN blocks'
  offset conv); either with `:f32`, in float32 (the kernel's float32
  instance), e.g. `64x64:f32`, `64x27c:f32`;
- `dcnCrR`: the bounded DCN `ops.cuda.deform_conv2d_bounded`, C -> C
  channels at radius R, weights packed once as the engine does, offsets
  reaching past R, a sigmoid mask (`dcn64r1`: qocc's `fusion_dcn0`;
  `dcn67r2`: q12's; both on the tile design; `dcn67r8`, `dcn128r4`,
  `dcn128r8`: the stream design); with `:stream` the stream design at a
  shape the plan gives the tile design (the checkout's `dcn_plan`
  replaced by its `_stream_plan` for that shape); a last `:f32` runs it in
  float32 (the float32 instances, weights packed in float32), e.g.
  `dcn64r1:f32`, `dcn67r2:stream:f32`;
- `warpCrR[:zero]`: the bounded warp `ops.cuda.bounded_warp` of a
  C-channel image, flows reaching past R (`warp3r16`: the RGB frame;
  `warp64r16`, the tools' feature map, and `warp64r4`: the wide
  instance), or with `:zero` a zero flow (every sample on its own pixel);
- `copyC`: `clone()` of a C-channel bf16 image, the bytes a warp of it
  moves at the least (its memory floor, no kernel of the port);
- `chain_NAME[:HOW]`: a chain of the model's trunk (`CHAINS`: `feat`
  64->64->64->64 with three ReLUs, `motion` 128->64->64->2 and `rec`
  64->64->32->3 with ReLU, ReLU, none, `rec67` the reference topology's
  67->64->32->3), weights packed once. HOW: none or `layers`,
  `conv_chain` (one conv-kernel launch a layer); `fused`, the fused chain
  kernel through `conv_chain_fused` (a checkout from before that wrapper
  runs `conv_chain(..., route="fused")` for `fused` and
  `route="layers"` for `layers`, its every shape's route, so `layers`
  times what none does on both sides and goes once no checkout from
  before `conv_chain_fused` is compared); `cudnn`,
  `F.conv2d` in bf16 then `relu` where the layer has one, layer by layer
  (a sequence of library calls, the "xla" route's trunk). A last `:f32`
  runs the chain in float32 (the kernels' float32 instances; `cudnn`
  with TF32 off), e.g. `chain_feat:fused:f32`, `chain_motion:f32`.
  `parts` (bf16, a checkout whose kernels read inputs in parts):
  `conv_chain` on the input as the model hands it over, `motion` as
  (features, a per-image context vector broadcast over the pixels),
  `rec67` as the [..., :67] view of a 72-wide buffer;
- `fuse:HOW`: the fuse projection, 1x1 67 -> 64 + bias: `parts`, the conv
  kernel (`ops.cuda.conv2d`, weights packed once) reading (features, the
  [..., :3] view of an 8-wide frame buffer); `cudnn`, what a forward that
  concatenates runs, `torch.cat` of the features and a 3-channel frame,
  then `models.layers.conv_nhwc` (cuDNN's conv and a bias add in bf16);
  `cat`, that concatenation into the conv kernel (which pads a copy);
  `whole`, the conv kernel on one contiguous 72-channel input (no copy).

Inputs and weights come from a seeded numpy generator, the same in every
process. Give the trees in turns (A, B, B, A) to cancel drift of the
card's clocks.

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
# A turn that has not ended by then raises (subprocess.TimeoutExpired).
TURN_TIMEOUT_S = 900
SHAPES = "64x64,128x64,64x32,6x64,64x27c"

# Run in each checkout: its own package, the API every checkout with the
# port's conv wrappers shares.
CHILD = r"""
import functools, json, sys
import numpy as np
import torch
import torch.nn.functional as F
args = json.loads(sys.argv[1])
sys.path.insert(0, args["tree"])
from vfi_tpu_torch.ops.cuda import (bounded_warp, conv2d, conv_chain,
                                    deform_conv2d_bounded, pack_conv_chain,
                                    pack_dcn)
from vfi_tpu_torch.ops.cuda import sampling
from vfi_tpu_torch.models.layers import conv_nhwc
try:
    from vfi_tpu_torch.ops.cuda import conv_chain_fused
    conv_chain_layers = conv_chain
except ImportError:      # an older checkout: `conv_chain(route=)` picks
    conv_chain_fused = functools.partial(conv_chain, route="fused")
    conv_chain_layers = functools.partial(conv_chain, route="layers")
CHAINS = {"feat": ((64, 64, 64, 64), (1, 1, 1)),
          "motion": ((128, 64, 64, 2), (1, 1, 0)),
          "rec": ((64, 64, 32, 3), (1, 1, 0)),
          "rec67": ((67, 64, 32, 3), (1, 1, 0))}
dev = torch.device(args["device"])
torch.backends.cudnn.allow_tf32 = False     # the float32 `cudnn` chains
cuda = dev.type == "cuda"
if not cuda:
    torch.set_num_threads(1)
b, h, w, n = args["b"], args["h"], args["w"], args["launches"]
rows = []
plan = sampling.dcn_plan


def bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)


def f32(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


# ms per launch of k back-to-back launches, queued behind a spin of the
# card so that the host's launch path does not pace them; the spin doubles
# until it outlasts the queueing. A call of many kernels (a sequence of
# library calls) can fill the card's launch queue, which then blocks the
# host until the spin ends: past a spin of 2^26 cycles k halves instead.
def device_ms(fn):
    spin, k = 1 << 22, n
    while True:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin)
        e0.record()
        for _ in range(k):
            fn()
        e1.record()
        queued_first = not e0.query()
        e1.synchronize()
        if queued_first or k == 1:
            return e0.elapsed_time(e1) / k
        if spin < 1 << 26:
            spin *= 2
        else:
            k //= 2


for shape in args["shapes"]:
    rng = np.random.default_rng(0)
    if shape.startswith("dcn"):
        spec, *hows = shape[3:].split(":")
        dt = torch.float32 if hows[-1:] == ["f32"] else torch.bfloat16
        c, r = (int(v) for v in spec.split("r"))
        sampling.dcn_plan = (sampling._stream_plan if "stream" in hows
                             else plan)
        x = f32(rng.standard_normal((b, h, w, c))).to(dt)
        off = f32(rng.standard_normal((b, h, w, 18)) * 0.8 * r).to(dt)
        mask = torch.sigmoid(f32(rng.standard_normal((b, h, w, 9)) * 2.0)
                             ).to(dt)
        wt = f32(rng.standard_normal((c, c, 3, 3)) / (9 * c) ** 0.5)
        bs = f32(rng.standard_normal((c,)) * 0.1)
        pk = pack_dcn(wt, bs) if dt == torch.bfloat16 else pack_dcn(wt, bs,
                                                                    dt)
        fn = lambda: deform_conv2d_bounded(x, off, mask, wt, bs, r,
                                           packed=pk)
    elif shape.startswith("warp"):
        spec, _, how = shape[4:].partition(":")
        c, r = (int(v) for v in spec.split("r"))
        img = bf(rng.uniform(0.0, 1.0, (b, h, w, c)))
        flow = bf(rng.standard_normal((b, h, w, 2)) * 10.0 * r / 16
                  * (how != "zero"))
        fn = lambda: bounded_warp(img, flow, r)
    elif shape.startswith("copy"):
        img = bf(rng.uniform(0.0, 1.0, (b, h, w, int(shape[4:]))))
        fn = img.clone
    elif shape.startswith("chain_"):
        name, *hows = shape[6:].split(":")
        dt = torch.float32 if hows[-1:] == ["f32"] else torch.bfloat16
        how = hows[0] if hows and hows[0] != "f32" else ""
        chans, acts = CHAINS[name]
        acts = tuple(bool(a) for a in acts)
        x = f32(rng.standard_normal((b, h, w, chans[0]))).to(dt)
        ws = [f32(rng.standard_normal((co, ci, 3, 3)) / (9 * ci) ** 0.5)
              for ci, co in zip(chans[:-1], chans[1:])]
        bs = [f32(rng.standard_normal((co,)) * 0.1) for co in chans[1:]]
        # bf16 packs without naming the dtype, as checkouts before the
        # float32 instances take it
        kw_pack = {} if dt == torch.bfloat16 else {"dtype": dt}
        if how == "cudnn":
            wb = [t.to(dt) for t in ws + bs]
            def fn(xn=x.permute(0, 3, 1, 2), n=len(ws)):
                for wt, bt, a in zip(wb[:n], wb[n:], acts):
                    xn = F.conv2d(xn, wt, bt, padding=1)
                    xn = torch.relu(xn) if a else xn
                return xn.permute(0, 2, 3, 1)
        elif how == "parts":
            pk = pack_conv_chain(ws, bs)
            if name == "motion":
                ctx = bf(rng.standard_normal((b, 64)))
                x = (x[..., :64], ctx[:, None, None, :].expand(b, h, w, 64))
            else:
                buf = torch.zeros(b, h, w, 72, dtype=dt, device=dev)
                buf[..., :chans[0]] = x
                x = buf[..., :chans[0]]
            fn = lambda: conv_chain(x, ws, bs, acts, packed=pk)
        else:
            pk = pack_conv_chain(ws, bs, **kw_pack)
            run_chain = {"fused": conv_chain_fused,
                         "layers": conv_chain_layers}.get(how, conv_chain)
            fn = lambda: run_chain(x, ws, bs, acts, packed=pk)
    elif shape.startswith("fuse"):
        how = shape.partition(":")[2]
        feat = bf(rng.standard_normal((b, h, w, 64)))
        rgb = bf(rng.uniform(0.0, 1.0, (b, h, w, 3)))
        proj = torch.nn.Conv2d(67, 64, 1).to(dev).requires_grad_(False)
        with torch.no_grad():
            proj.weight.copy_(f32(rng.standard_normal((64, 67, 1, 1)) / 67 ** 0.5))
            proj.bias.copy_(f32(rng.standard_normal((64,)) * 0.1))
        if how == "parts":
            from vfi_tpu_torch.ops.cuda import pack_conv2d
            buf = torch.zeros(b, h, w, 8, dtype=torch.bfloat16, device=dev)
            buf[..., :3] = rgb
            parts = (feat, buf[..., :3])
            pk = pack_conv2d(proj.weight, proj.bias)
            fn = lambda: conv2d(parts, proj.weight, proj.bias, packed=pk)
        elif how == "cat":
            fn = lambda: conv2d(torch.cat([feat, rgb], dim=-1), proj.weight,
                                proj.bias)
        elif how == "whole":
            x72 = torch.cat([feat, rgb, rgb[..., :2] * 0, rgb * 0], dim=-1)
            w72 = torch.nn.functional.pad(proj.weight, (0, 0, 0, 0, 0, 5))
            fn = lambda: conv2d(x72, w72, proj.bias)
        else:
            fn = lambda: conv_nhwc(torch.cat([feat, rgb], dim=-1), proj,
                                   False)
    else:
        spec, _, how = shape.partition(":")
        chain = spec.endswith("c")
        cin, cout = (int(v) for v in spec.rstrip("c").split("x"))
        x = f32(rng.standard_normal((b, h, w, cin), np.float32))
        x = x if how == "f32" else x.to(torch.bfloat16)
        wt = f32(rng.standard_normal((cout, cin, 3, 3)) * 0.05)
        bs = f32(rng.standard_normal((cout,)))
        if chain:
            fn = lambda: conv_chain(x, [wt], [bs], (False,))
        else:
            fn = lambda: conv2d(x, wt, bs, True)
    for _ in range(3):
        fn()
    if cuda:
        ms = device_ms(fn)
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
                    help="comma list of CinxCout (conv2d + ReLU), "
                         "CinxCoutc (one-layer conv_chain), either [:f32], "
                         "dcnCrR[:stream][:f32] "
                         "(bounded DCN), warpCrR[:zero] (bounded warp), "
                         "copyC (an image's clone) or "
                         "chain_NAME[:fused|layers|cudnn][:f32] (a trunk "
                         "chain, bf16 or float32)")
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
                             cwd=tree, capture_output=True, text=True,
                             timeout=TURN_TIMEOUT_S)
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
