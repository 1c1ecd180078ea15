"""One reader a per-layer metric, `<name>.py`, found by the metric's name.

Each declares LAYER, UNIT, SOURCE, MOVES and BETTER (checked against
BENCHMARK.json) and `read(ctx) -> float | None`. `ctx` is a dict:
"trace" (`trace.Reduced`, the traced slice), "frames" (midpoints
completed in it), "calls" (the batch of each call in it), "size" (H, W),
"config" (the configuration), and for a serving cell "serve" (counter
deltas and spans over the window). A reader that finds nothing to read
returns None, and the metric is left out of the line.
"""
