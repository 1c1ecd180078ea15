"""The share of the traced slice in which no kernel ran on the card while
the host was copying frames in (`vfi.upload`: the host-to-device copies,
the drains they force and the uint8 conversion)."""

from vfibench.metrics._spans import idle_pct_in

LAYER = "engine: infer/pair.py and the ops/cuda wrappers"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "lower"


def read(ctx):
    return idle_pct_in(ctx["trace"], "vfi.upload")
