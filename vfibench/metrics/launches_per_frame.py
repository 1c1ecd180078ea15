"""Every CUDA kernel launched in the traced slice (the port's kernels and
PyTorch's alike; copies and memsets are not kernels) per midpoint."""

LAYER = "engine: infer/pair.py and the ops/cuda wrappers"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "lower"


def read(ctx):
    if not ctx.get("frames"):
        return None
    return len(ctx["trace"].kernels()) / ctx["frames"]
