"""Training-step throughput on the kernel paths, on the card.

    python -m vfi_tpu_torch.tools.bench_train_step [--crop 256]
        [--batch 16] [--iters 6] [--accum 8]
        [--paths plain,kernels,kernels+conv,handbwd] [--json_out F]
        [--device cuda|cpu] [--smoke]

The counterpart of the JAX package's `tools/bench_train_step.py`: the
trainer's whole step (forward, every loss, backward, the AdamW update) on
synthetic batches (three standard-normal frames from
`np.random.default_rng(0)`, reused every step) for each path of `--paths`:

- `plain` (JAX: `xla`): the kernels' plain versions (`use_pallas false`);
- `kernels` (`pallas`): the DCN and warp kernels, their backward autograd
  of the plain versions (`ops/cuda/grad.py`);
- `kernels+conv` (`pallas+conv`): also the conv chains
  (`conv_kernel pallas`);
- `handbwd` (`pallas_handbwd`): `kernels` with the DCN's backward the
  hand-written `deform_conv2d_shifts_bwd` (`ops.cuda.hand_backward`), in
  plain PyTorch: the yardstick a CUDA backward of the DCN must beat.

The JAX names are taken as aliases. The config is `config/train_config.yaml`
(its values written here as `--key value` overrides, `YAML_OVERRIDES`: the
card's machine has no PyYAML) with the JAX tool's overrides (`overrides`):
batch `--batch`, crop `--crop`, `--accum` microbatches, remat, R=2, warp
bound 16, `fuse_project`, the flow prior with the photometric pyramid,
cascade 2, one epoch. Each path builds a fresh Trainer (seeded: every path
starts from the same parameters), with its outputs in a temporary
directory and the data directories under the repository's root. The first
step warms up and is not timed; its loss and its gradient (flat, after the
step's clip) are kept, so that paths can be compared on one batch. Then
`--iters` steps, each synchronised: ms a step and samples/s, one line a
path, and the JSON line of all of them (`--json_out` writes it to a file
too). `--smoke` runs a tiny float32 model (mid 8, one block) at batch 2,
crop 32, no accumulation and no VGG, one step, on the CPU with
`--device cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from vfi_tpu_torch.infer.pair import resolve_device
from vfi_tpu_torch.ops.cuda import hand_backward, launch_counts
from vfi_tpu_torch.tools import ROOT, card_line
from vfi_tpu_torch.train import Trainer
from vfi_tpu_torch.utils.config import TrainConfig, load_train_config

# config/train_config.yaml, key by key (tests/test_torch_user_tools.py
# holds them equal to the file).
YAML_OVERRIDES = [
    "--batch_size", "4", "--learning_rate", "0.0005", "--num_epochs", "100",
    "--train_data_dir", "data/processed/train",
    "--val_data_dir", "data/processed/val",
    "--checkpoint_path", "checkpoints", "--best_model_path", "best_ema_vfi",
    "--charbonnier_weight", "0.5", "--vgg_weight", "0.15",
    "--color_weight", "0.3", "--gradient_weight", "0.1",
    "--temporal_weight", "0.15", "--gradient_order", "1",
    "--temporal_alpha", "1.0", "--output_image_path", "output_images",
    "--color_jitter.brightness", "0.2", "--color_jitter.contrast", "0.2",
    "--color_jitter.saturation", "0.2", "--color_jitter.hue", "0.1",
    "--crop_size", "[256, 256]", "--random_rotation", "true",
    "--horizontal_flip", "true", "--random_grayscale", "0.2",
    "--bf16", "true", "--mesh.data", "-1", "--mesh.spatial", "1",
    "--resume", "true",
]
# Each path's overrides, and the JAX tool's names for the paths.
PATHS = {
    "plain": ["--use_pallas", "false"],
    "kernels": ["--use_pallas", "true"],
    "kernels+conv": ["--use_pallas", "true", "--conv_kernel", "pallas"],
    "handbwd": ["--use_pallas", "true"],
}
ALIASES = {"xla": "plain", "pallas": "kernels", "pallas+conv": "kernels+conv",
           "pallas_handbwd": "handbwd"}
SMOKE = ["--mid_channels", "8", "--num_blocks", "1", "--bf16", "false",
         "--vgg_weight", "0"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--accum", type=int, default=8,
                    help="gradient-accumulation microbatches (flagship "
                         "recipe: 8 -> microbatch 2 at batch 16)")
    ap.add_argument("--paths", default="plain,kernels,kernels+conv")
    ap.add_argument("--flow_prior", action="store_true", default=True)
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny float32 model at batch 2, crop 32, one "
                         "step (runs on the CPU with --device cpu)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.crop, args.batch, args.accum, args.iters = 32, 2, 1, 1
    paths = [ALIASES.get(p, p) for p in args.paths.split(",")]
    unknown = [p for p in paths if p not in PATHS]
    if unknown:
        raise SystemExit(f"unknown --paths {unknown}; the port has "
                         f"{list(PATHS)} (or the JAX names "
                         f"{list(ALIASES)})")
    args.paths = paths
    return args


def overrides(args, path: str) -> list:
    """The JAX tool's overrides of the YAML config for one path."""
    return [
        "--batch_size", str(args.batch),
        "--crop_size", f"[{args.crop},{args.crop}]",
        "--target_unit_range", "true",
        "--dcn_max_offset", "2", "--warp_max_flow", "16",
        "--fuse_project", "true",
        "--flow_prior", "true" if args.flow_prior else "false",
        "--flow_photo_pyramid", "true",
        "--cascade_levels", "2",
        "--accum_steps", str(args.accum),
        "--remat", "true",
        "--num_epochs", "1",
    ] + PATHS[path] + (SMOKE if args.smoke else [])


def config(args, path: str) -> TrainConfig:
    """config/train_config.yaml with the path's overrides, read without
    PyYAML."""
    return load_train_config(None, YAML_OVERRIDES + overrides(args, path))


def flat_grad(trainer) -> torch.Tensor:
    return torch.cat([p.grad.detach().float().flatten()
                      for p in trainer.state.leaves() if p.grad is not None])


def run_path(args, path: str, dev: torch.device, tmp: str) -> dict:
    cfg = config(args, path)
    cfg = dataclasses.replace(
        cfg, train_data_dir=os.path.join(ROOT, cfg.train_data_dir),
        val_data_dir=os.path.join(ROOT, cfg.val_data_dir),
        checkpoint_path=os.path.join(tmp, path, "checkpoints"),
        best_model_path=os.path.join(tmp, path, "best"),
        output_image_path=os.path.join(tmp, path, "images"))
    trainer = Trainer(cfg, device=dev)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.crop, args.crop, 3)
    f0, ft, f1 = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for _ in range(3))
    cuda = dev.type == "cuda"
    with hand_backward() if path == "handbwd" else contextlib.nullcontext():
        metrics = trainer.train_step(trainer.state, f0, ft, f1)  # warm-up
        first_loss = float(metrics["loss"])
        grad = flat_grad(trainer)
        before = launch_counts()
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            metrics = trainer.train_step(trainer.state, f0, ft, f1)
            if cuda:
                torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / args.iters
    return {"ms_per_step": dt * 1e3, "samples_per_s": args.batch / dt,
            "first_loss": first_loss, "last_loss": float(metrics["loss"]),
            "launches_per_step": {k: (v - before[k]) / args.iters
                                  for k, v in launch_counts().items()},
            "_grad": grad}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    print(card, flush=True)
    results, grads = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in args.paths:
            res = run_path(args, path, dev, tmp)
            grads[path] = res.pop("_grad")
            results[path] = res
            print(f"{path:12s} crop {args.crop} b{args.batch}: "
                  f"{res['ms_per_step']:8.1f} ms/step  "
                  f"{res['samples_per_s']:7.2f} samples/s", flush=True)
    out = {"tool": "bench_train_step", "device": str(dev),
           "card": card, "crop": args.crop, "batch": args.batch,
           "accum": args.accum, "iters": args.iters, "results": results}
    print(json.dumps(out), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(out, fh, indent=1)
    return {**out, "grads": grads}


if __name__ == "__main__":
    main()
