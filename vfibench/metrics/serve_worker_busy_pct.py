"""The batcher worker's busy share of the window: the spans the harness's
engine proxy records around each `engine.midpoints` call and its copy to
the host, summed, over the window."""

LAYER = "serve worker to engine"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "latency_p95_ms"
BETTER = "lower"


def read(ctx):
    s = ctx.get("serve")
    if not s or s["window_s"] <= 0.0:
        return None
    return 100.0 * s["worker_busy_s"] / s["window_s"]
