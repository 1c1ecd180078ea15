"""Tools of the port, the counterparts of the JAX package's `tools/`:

    python -m vfi_tpu_torch.tools.bench_conv        [--device cuda] [--smoke]
    python -m vfi_tpu_torch.tools.bench_kernels     [--device cuda] [--smoke]
    python -m vfi_tpu_torch.tools.profile_forward   [--device cuda] [--smoke]
    python -m vfi_tpu_torch.tools.dump_offsets --out F  [--device cuda]
    python -m vfi_tpu_torch.tools.offset_stats      [--device cuda] [--smoke]
    python -m vfi_tpu_torch.tools.bench_flowprior   [--device cuda] [--smoke]
    python -m vfi_tpu_torch.tools.bench_train_step  [--device cuda] [--smoke]
    python -m vfi_tpu_torch.tools.video_demo --model_path M  [--smoke]

`bench_conv` and `bench_kernels` time the conv, DCN and warp kernels;
`profile_forward` breaks the model's forward down by device op and
category; `dump_offsets` writes a checkpoint's DCN offset and mask planes
(which `bench_kernels --offsets` reads) and `offset_stats` counts the
(tap, shift) pairs they activate; `bench_flowprior` prices the flow
prior; `bench_train_step` times the training step on its kernel paths;
`video_demo` times the infer CLI's clip up-conversion end to end (it needs
cv2; `--smoke` runs a tiny clip on the CPU).
They run on the card (`--device cuda`, the default) and on the CPU only
when asked (`--device cpu --smoke`: a tiny shape through the plain
versions, for the tests). `time_interleaved` is the kernel tools' shared
timer, `build_model` the model tools' loader. `conv_turns` compares
checkouts on the card, one process a turn: device time of the conv, DCN
and warp kernels. `bench_serve` is the serving load generator (closed-loop
clients against `python -m vfi_tpu_torch.cli.serve` or an in-process
server).
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vfi_tpu_torch.models import EMAVFI
from vfi_tpu_torch.utils.convert import (infer_model_dims, load_params_npz,
                                         params_from_jax)

# The repository's root: the tracked checkpoints and frames lie under it.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def time_interleaved(fns: Dict[str, Callable], iters: int,
                     device: torch.device, warmup: int = 2) -> dict:
    """Median ms per call of each function, timed in turns: each round
    runs every function once, in order. On a CUDA device each call is
    bracketed by CUDA events, all read after one synchronise at the end:
    a call that keeps the device busy times its device work, and one
    shorter than its host launch path (below ~0.1 ms) takes in the host's
    gap; the calls between two of one function's runs also leave it a
    cooler L2 cache than back-to-back runs. On the CPU: the host clock."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    marks = {name: [] for name in fns}
    for _ in range(iters):
        for name, fn in fns.items():
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                marks[name].append((a, b))
            else:
                t0 = time.perf_counter()
                fn()
                marks[name].append((t0, time.perf_counter()))
    if cuda:
        torch.cuda.synchronize(device)
        return {name: float(np.median([a.elapsed_time(b) for a, b in m]))
                for name, m in marks.items()}
    return {name: float(np.median([(b - a) * 1e3 for a, b in m]))
            for name, m in marks.items()}


def max_abs_err(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The largest |got - ref| and the largest |ref| (its scale)."""
    return {"max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "ref_max_abs": ref.float().abs().max().item()}


def card_line(dev: torch.device) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line, or "cpu"
    for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return lines[dev.index or 0]


def build_model(ckpt: Optional[str], dev: torch.device, **kw) -> EMAVFI:
    """EMAVFI on `dev`, in eval mode, packed for the kernels: the weights
    and dims of the checkpoint `ckpt` (an .npz in the JAX layout, whose
    `fuse_project` is read off the tree), or with None the JAX model's
    default dims at random from `torch.manual_seed(0)`. `kw`: the model's
    other arguments (dtype, radii, conv_kernel, use_kernels)."""
    if ckpt is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = EMAVFI(**kw)
    else:
        params = load_params_npz(ckpt)
        dims = infer_model_dims(params)
        model = EMAVFI(in_channels=dims["in_channels"],
                       mid_channels=dims["mid_channels"],
                       num_blocks=dims["num_blocks"],
                       fuse_project=dims["fuse_project"], **kw)
        model.load_state_dict(params_from_jax(params))
    model.to(dev).eval()
    model.pack_kernel_weights()
    return model


def uniform_frames(b: int, h: int, w: int, dev: torch.device) -> tuple:
    """Two (b, h, w, 3) float32 frames, uniform in [0, 1) from numpy seeds
    1 and 2 (the JAX tools' PRNGKey(1) and (2))."""
    return tuple(torch.from_numpy(np.random.RandomState(seed).uniform(
        size=(b, h, w, 3)).astype(np.float32)).to(dev) for seed in (1, 2))
