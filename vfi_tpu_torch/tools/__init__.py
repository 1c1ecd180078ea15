"""Kernel tools of the port, the counterparts of the JAX package's
`tools/bench_conv.py` and `tools/bench_kernels.py`:

    python -m vfi_tpu_torch.tools.bench_conv     [--device cuda] [--smoke]
    python -m vfi_tpu_torch.tools.bench_kernels  [--device cuda] [--smoke]

They run on the card (`--device cuda`, the default) and on the CPU only
when asked (`--device cpu --smoke`: a tiny shape through the plain
versions, for the tests). `time_interleaved` is their shared timer.
Two more compare checkouts on the card, one process a turn:
`conv_turns` (device time of the conv, DCN and warp kernels) and
`launch_path` (the RGB warp's host launch path, piece by piece).
`bench_serve` is the serving load generator (closed-loop clients against
`python -m vfi_tpu_torch.cli.serve` or an in-process server).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch


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
