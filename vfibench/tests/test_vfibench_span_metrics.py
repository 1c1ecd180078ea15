"""The readers of the program's engine spans (`forward_idle_pct`,
`upload_idle_pct`, `forward_host_ms_per_frame`) on hand-built slices,
against values worked out by hand."""

import random

import pytest

from vfibench.manifest import load_manifest, load_metric
from vfibench.trace import Reduced

NAMES = ("forward_idle_pct", "upload_idle_pct", "forward_host_ms_per_frame")


def _readers():
    specs = {m["name"]: m for m in load_manifest()["per_layer"]}
    return {n: load_metric(specs[n]) for n in NAMES + ("device_idle_pct",)}


READ = _readers()


def _slice():
    """One call of 8 midpoints in a 1 ms slice: two launches, each two
    uploads, a forward and an output. Kernels run over [0, 30], [120, 200],
    [230, 420], [560, 700], [720, 880] us, a copy over [45, 58]: no kernel
    runs over [30, 120], [200, 230], [420, 560], [700, 720], [880, 1000],
    400 us in all."""
    host = [(10, 900, "vfi.midpoints"),
            (20, 450, "vfi.launch"), (460, 890, "vfi.launch"),
            (25, 60, "vfi.upload"), (60, 100, "vfi.upload"),
            (465, 500, "vfi.upload"), (500, 540, "vfi.upload"),
            (100, 400, "vfi.forward"), (540, 850, "vfi.forward"),
            (400, 450, "vfi.output"), (850, 890, "vfi.output"),
            (40, 60, "cudaStreamSynchronize"),
            (80, 100, "cudaStreamSynchronize"),
            (200, 230, "cudaStreamSynchronize"),
            (600, 610, "cudaStreamSynchronize"),
            (880, 890, "cudaStreamSynchronize"),
            (130, 135, "cudaLaunchKernel"), (150, 160, "aten::cat"),
            (0, 1000, "vfibench.call")]
    device = [(0, 30, "conv2d_kernel<4>"), (120, 200, "conv2d_kernel<2>"),
              (230, 420, "dcn_tile_kernel<16, 8>"),
              (560, 700, "elementwise_kernel"), (720, 880, "cat_kernel"),
              (45, 58, "Memcpy HtoD (Pinned -> Device)")]
    return {"trace": Reduced(0.0, 1000.0, device, host), "calls": [8],
            "frames": 8}


def test_readers_by_hand():
    ctx = _slice()
    assert READ["device_idle_pct"].read(ctx) == pytest.approx(40.0)
    # forward [100, 400]: idle [100, 120] + [200, 230]; [540, 850]:
    # [540, 560] + [700, 720]; 90 us of 1000
    assert READ["forward_idle_pct"].read(ctx) == pytest.approx(9.0)
    # uploads: [30, 60] + [60, 100] + [465, 500] + [500, 540] = 145 us
    assert READ["upload_idle_pct"].read(ctx) == pytest.approx(14.5)
    # forward host 300 + 310 us less the blocking calls inside them
    # (30 + 10 us), over 8 midpoints
    assert READ["forward_host_ms_per_frame"].read(ctx) == pytest.approx(
        0.570 / 8)


def test_no_spans_read_nothing():
    ctx = _slice()
    tr = ctx["trace"]
    tr.host = [h for h in tr.host if not h[2].startswith("vfi.")]
    for n in NAMES:
        assert READ[n].read(ctx) is None
    assert READ["device_idle_pct"].read(ctx) == pytest.approx(40.0)


def test_host_cost_reads_only_whole_calls():
    ctx = _slice()
    ctx["calls"] = [8, 8]     # a call the slice does not hold whole
    assert READ["forward_host_ms_per_frame"].read(ctx) is None
    ctx = _slice()
    tr = ctx["trace"]
    # a slice that starts inside the first forward: it and its call are
    # clipped to the slice, so no whole call is left
    tr.t0 = 150.0
    tr.host = [(max(s, 150.0), e, n) for s, e, n in tr.host if e > 150.0]
    tr.device = [(max(s, 150.0), e, n) for s, e, n in tr.device if e > 150.0]
    assert READ["forward_host_ms_per_frame"].read(ctx) is None
    # the idle readers take what lies in the slice: [200, 230], [540, 560],
    # [700, 720] of 850 us
    assert READ["forward_idle_pct"].read(ctx) == pytest.approx(
        100 * 70 / 850)


@pytest.mark.parametrize("seed", range(5))
def test_span_idle_never_exceeds_device_idle(seed):
    rng = random.Random(seed)
    host, device, t = [], [], 0.0
    for _ in range(20):
        a = t + rng.uniform(0, 20)
        b = a + rng.uniform(1, 30)
        c = b + rng.uniform(1, 200)
        host += [(a, b, "vfi.upload"), (b, c, "vfi.forward")]
        t = c + rng.uniform(0, 30)
    for _ in range(60):
        s = rng.uniform(0, t)
        device.append((s, min(t, s + rng.uniform(1, 50)), "k"))
    ctx = {"trace": Reduced(0.0, t, device, host), "calls": [1],
           "frames": 1}
    total = READ["device_idle_pct"].read(ctx)
    parts = READ["forward_idle_pct"].read(ctx) + \
        READ["upload_idle_pct"].read(ctx)
    assert 0 <= parts <= total + 1e-9
