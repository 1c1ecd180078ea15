"""The host's cost to launch the forward: the host ms inside the engine's
`vfi.forward` spans that lie wholly in the traced slice, less the
blocking runtime calls inside them (time the host waits on the card),
over the midpoints of the calls (`vfi.midpoints`) those spans belong to.
Measured under the profiler, which adds its own cost to every op."""

import re

from vfibench.metrics._spans import has_spans, intervals, overlap_s

LAYER = "engine: infer/pair.py and the ops/cuda wrappers"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "lower"
# CUDA runtime calls (and their cu* counterparts) that return only when
# the card has caught up. On an H100 with torch 2.11 a qocc or q12 call
# shows six, all `cudaStreamSynchronize`: one after each of the four
# uploads and two in the cascade (`vfi.forward` holds those two).
BLOCKING = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize|"
                      r"cudaEventSynchronize|cudaMemcpy|cudaMemcpy2D|"
                      r"cuStreamSynchronize|cuCtxSynchronize|"
                      r"cuEventSynchronize)$")


def read(ctx):
    tr = ctx["trace"]
    if not has_spans(tr):
        return None
    fwd = intervals(tr, "vfi.forward", whole=True)
    calls = [(s, e) for s, e in intervals(tr, "vfi.midpoints", whole=True)
             if any(s <= a and b <= e for a, b in fwd)]
    if not fwd or len(calls) != len(ctx.get("calls") or ()):
        return None
    blocked = [(s, e) for s, e, n in tr.host if BLOCKING.match(n)]
    host_s = sum(e - s for s, e in fwd) / 1e6 - overlap_s(fwd, blocked)
    return 1e3 * host_s / ctx["frames"]
