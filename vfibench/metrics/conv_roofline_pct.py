"""The 3x3 conv chains' and offset convs' share of their roofline: their
least time (`counts.conv.chain`) over the device time of the port's conv
kernels (`csrc/conv2d.cu`, `csrc/conv_chain.cu`) in the traced slice."""

import re

from vfibench.metrics._roofline import share

LAYER = "kernels: csrc/*.cu via ops/cuda"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "higher"
KERNELS = re.compile(r"\b(conv2d|conv2d_f32|conv_chain|conv_chain_f32)_kernel\b")


def read(ctx):
    return share(ctx, "chain", KERNELS)
