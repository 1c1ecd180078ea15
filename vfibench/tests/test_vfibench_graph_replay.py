"""The reader of the engine's graph replays (`graph_replay_pct`) on
hand-built slices: every launch replayed, half of them, and none of the
spans it reads."""

import pytest

from vfibench.manifest import load_manifest, load_metric
from vfibench.trace import Reduced

SPEC = {m["name"]: m for m in load_manifest()["per_layer"]}["graph_replay_pct"]
READ = load_metric(SPEC)


def _slice(replayed):
    """Two calls of two launches in a 1 ms slice, each launch an upload,
    a forward and an output; the forwards of the launches `replayed`
    (indices) hold a `vfi.replay`. A third launch starts before the slice
    and is clipped to it."""
    host = [(0, 40, "vfi.launch"), (0, 30, "vfi.forward"),
            (0, 30, "vfi.replay")]
    for i, s in enumerate((100, 300, 500, 700)):
        host += [(s, s + 150, "vfi.launch"), (s, s + 40, "vfi.upload"),
                 (s + 40, s + 120, "vfi.forward"),
                 (s + 120, s + 150, "vfi.output")]
        if i in replayed:
            host.append((s + 45, s + 60, "vfi.replay"))
        else:
            host.append((s + 45, s + 60, "vfi.prior"))
    host += [(90, 460, "vfi.midpoints"), (490, 860, "vfi.midpoints")]
    device = [(s + 50, s + 140, "conv2d_kernel<4>")
              for s in (100, 300, 500, 700)]
    return {"trace": Reduced(0.0, 1000.0, device, host), "calls": [8, 8],
            "frames": 16}


@pytest.mark.parametrize("replayed,want", [((0, 1, 2, 3), 100.0),
                                           ((1, 3), 50.0)])
def test_share_of_whole_launches_that_replay(replayed, want):
    assert READ.read(_slice(replayed)) == pytest.approx(want)


def test_no_spans_read_nothing():
    ctx = _slice((0, 1, 2, 3))
    tr = ctx["trace"]
    tr.host = [h for h in tr.host if not h[2].startswith("vfi.")]
    assert READ.read(ctx) is None


def test_a_program_without_graphs_reads_nothing():
    """Spans but no `vfi.replay` (a program without CUDA graphs): None,
    not 0."""
    ctx = _slice(())
    tr = ctx["trace"]
    tr.host = [h for h in tr.host if h[2] != "vfi.replay"]
    assert READ.read(ctx) is None
