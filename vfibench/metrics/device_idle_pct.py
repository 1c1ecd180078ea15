"""The share of the traced slice in which no kernel ran on the card: one
minus the union of the kernels' intervals over the slice's length."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
BETTER = "lower"


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s(tr.kernels()) / tr.window_s)
