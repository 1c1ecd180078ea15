"""Offline traffic: a video pipeline's closed loop over the engine.

One call at a time: `engine.midpoints(f0, f1)` on `batch` uint8 pairs at
`size`, the result copied to the host as a video writer must, the next
call as soon as the copy is done. The frames live in page-locked host
memory and each result is copied into one of two page-locked buffers, as
a pipeline that reuses its buffers does: the copies then run at the DMA
engines' rate, not at the rate at which a busy host stages pageable
memory (on an H100, qocc read 71-81 frames/s across runs with pageable
buffers, 81-84 with these). The pairs cycle through a seeded pool of
`pool` distinct pairs (`inputs.make_pool`). Set-up builds the engine and
runs `warmup_calls` calls of the window's own shapes; the window then runs
for `seconds` and ends with the first call that completes after it, once
every pair of the pool has been answered.

`frames_per_s` is every midpoint copied to the host in the window over
the window's length. With `trace`, the profiler records `slice_calls`
calls from the first call that starts after `slice_at` of the window.

Parameters (the workload file's "params"): size, crop, pool, batch,
warmup_calls, slice_at, slice_calls.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from vfibench.check import Sampler
from vfibench.inputs import make_pool


def run(ctx: dict) -> dict:
    import torch
    from torch.profiler import record_function

    from vfibench.program import build_engine
    from vfibench.trace import Slice

    p, seconds, dev = ctx["params"], ctx["seconds"], ctx["device"]
    size, b = tuple(p["size"]), p["batch"]
    t_imp = time.perf_counter()
    f0, f1 = make_pool(ctx["seed"], p["pool"], size, tuple(p["crop"]))
    t_pool = time.perf_counter()
    if p["pool"] % b:
        raise ValueError("the pool must hold whole batches")
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        f0, f1 = (torch.from_numpy(x).pin_memory() for x in (f0, f1))
        outs = [torch.empty((b, *size, 3), dtype=torch.uint8).pin_memory()
                for _ in range(2)]
    calls = [(f0[i:i + b], f1[i:i + b], i) for i in range(0, p["pool"], b)]
    engine = build_engine(ctx["config"], dev)
    t_engine = time.perf_counter()

    def call(k: int):
        a, c, i0 = calls[k % len(calls)]
        with record_function("vfibench.call"):
            out = engine.midpoints(a, c)
        with record_function("vfibench.to_host"):
            if cuda:
                return outs[k % 2].copy_(out).numpy(), i0
            return out.cpu().numpy(), i0

    for k in range(p["warmup_calls"]):
        call(k)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx["t0"]
    print(f"set-up {setup_s:.3f} s: start and imports {t_imp - ctx['t0']:.3f}, "
          f"pool {t_pool - t_imp:.3f}, engine {t_engine - t_pool:.3f}, "
          f"warm-up {ctx['t0'] + setup_s - t_engine:.3f}", file=sys.stderr)

    sampler = Sampler(ctx["seed"])
    tracer = Slice(dev) if ctx["trace"] else None
    slice_calls, frames, k = [], 0, 0
    start = time.perf_counter()
    while True:
        if tracer is not None and not (tracer.on or tracer.done) and \
                time.perf_counter() - start >= p["slice_at"] * seconds:
            tracer.start()
        host, i0 = call(k)
        if tracer is not None and tracer.on:
            slice_calls.append(len(host))
            if len(slice_calls) == p["slice_calls"]:
                tracer.stop()
        for j in range(len(host)):
            sampler.offer(i0 + j, host[j])
        frames += len(host)
        k += 1
        elapsed = time.perf_counter() - start
        if elapsed >= seconds and k >= len(calls) and (
                tracer is None or tracer.done):
            break
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    trace_ctx = None
    if tracer is not None:
        trace_ctx = {"trace": tracer.reduce(), "calls": slice_calls,
                     "frames": sum(slice_calls), "size": size,
                     "config": ctx["config"]}

    def release():
        nonlocal engine
        engine = None

    return {"e2e": {"frames_per_s": frames / elapsed, "setup_s": setup_s},
            "attempted": frames, "failed": 0, "samples": sampler.items,
            "pool": tuple(np.asarray(x) for x in (f0, f1)),
            "memory_peak_bytes": peak,
            "trace_ctx": trace_ctx, "release": release}
