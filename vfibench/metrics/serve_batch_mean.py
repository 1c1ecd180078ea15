"""Requests per engine batch over the window: deltas of the batcher's
`BatcherStats` counters (requests, batches)."""

LAYER = "serve: serve/batcher.py"
UNIT = "requests"
SOURCE = "program_counter"
MOVES = "latency_p95_ms"
BETTER = "higher"


def read(ctx):
    s = ctx.get("serve")
    if not s or not s["batches"]:
        return None
    return s["requests"] / s["batches"]
