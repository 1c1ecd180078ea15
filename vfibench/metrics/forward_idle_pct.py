"""The share of the traced slice in which no kernel ran on the card while
the host was inside the engine's forward (`vfi.forward`: normalisation,
flow prior and model): the card starved by the model's launch path, the
cascade's mid-forward copy included."""

from vfibench.metrics._spans import idle_pct_in

LAYER = "engine: infer/pair.py and the ops/cuda wrappers"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "lower"


def read(ctx):
    return idle_pct_in(ctx["trace"], "vfi.forward")
