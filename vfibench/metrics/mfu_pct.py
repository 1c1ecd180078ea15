"""The whole step's share of the card's bf16 peak: the model FLOPs of
the midpoints completed in the traced slice (`counts.model`) over the
slice's seconds, over 989 TFLOP/s."""

from vfibench.counts import PEAK_BF16
from vfibench.counts.model import flops

LAYER = "step: infer/pair.py FrameInterpolator to models/"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "higher"


def read(ctx):
    if not ctx.get("frames"):
        return None
    cfg = ctx["config"]
    h, w = ctx["size"]
    total = flops(cfg["widths"], cfg["engine"], 1, h, w) * ctx["frames"]
    return 100.0 * total / ctx["trace"].window_s / PEAK_BF16
