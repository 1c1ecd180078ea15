"""The deformable convs' share of their roofline: the least time of the
three DCNs of every call (max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s),
`counts.dcn`) over the device time of the port's DCN kernels
(`csrc/dcn_bounded.cu`) in the traced slice."""

import re

from vfibench.metrics._roofline import share

LAYER = "kernels: csrc/*.cu via ops/cuda"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "higher"
KERNELS = re.compile(r"\bdcn_\w*kernel\b")


def read(ctx):
    return share(ctx, "dcn", KERNELS)
