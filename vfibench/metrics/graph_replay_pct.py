"""How often the engine replays a captured CUDA graph: 100 x the engine
launches (`vfi.launch` spans lying wholly in the traced slice) that hold
a `vfi.replay` span, over all such launches. A program without the span
(no graphs) gives nothing to read."""

from vfibench.metrics._spans import has_spans, intervals

LAYER = "engine: infer/pair.py and the ops/cuda wrappers"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"
BETTER = "higher"


def read(ctx):
    tr = ctx["trace"]
    if not has_spans(tr):
        return None
    launches = intervals(tr, "vfi.launch", whole=True)
    replays = intervals(tr, "vfi.replay")
    if not launches or not any(n == "vfi.replay" for _, _, n in tr.host):
        return None
    held = sum(any(s <= a and b <= e for a, b in replays)
               for s, e in launches)
    return 100.0 * held / len(launches)
