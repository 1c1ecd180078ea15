"""The port's host spans (`utils.profiling.span`) on the CPU: the span tree
of an engine call under `torch.profiler` (flow prior, cascade 2,
`io_uint8`, two guard launches), no `record_function` entered without a
profiler, the same midpoints with and without one, and `device_profile`'s
span table (the CPU's ops by their enclosing span; on the card, kernels by
the runtime call that shares their correlation id, on hand-built events).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vfi_tpu_torch.infer.pair import FrameInterpolator
from vfi_tpu_torch.tools import profile_forward
from vfi_tpu_torch.utils import profiling
from vfi_tpu_torch.utils.convert import load_params_npz
from vfi_tpu_torch.utils.profiling import device_profile, span, span_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
H, W, B = 16, 32, 4
STAGES = ("vfi.normalize", "vfi.prior", "vfi.cascade", "vfi.features",
          "vfi.context", "vfi.motion", "vfi.warp", "vfi.fusion",
          "vfi.reconstruct")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    """The qocc checkpoints at the flagship's settings, two launches of
    two pairs for a batch of four."""
    return FrameInterpolator(
        load_params_npz(QOCC + ".npz"),
        flow_params=load_params_npz(QOCC + ".flow.npz"), device="cpu",
        io_uint8=True, cascade_levels=2, dcn_max_offset=1,
        warp_max_flow=16, conv_kernel="pallas", max_px_per_launch=2 * H * W)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    f0 = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    return f0, np.roll(f0, (1, 2), axis=(1, 2))


@pytest.fixture(scope="module")
def traced(engine, frames):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = engine.midpoints(*frames)
    return out, list(prof.events())


def _span_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("vfi."):
        p = p.cpu_parent
    return p


def _children(ev):
    return [c for c in sorted(ev.cpu_children,
                              key=lambda c: c.time_range.start)
            if c.name.startswith("vfi.")]


def test_span_tree_of_an_engine_call(traced):
    _, events = traced
    roots = [e for e in events if e.name.startswith("vfi.")
             and _span_parent(e) is None]
    assert [r.name for r in roots] == ["vfi.midpoints"]
    launches = _children(roots[0])
    assert [c.name for c in launches] == ["vfi.launch"] * 2
    for launch in launches:
        kids = _children(launch)
        assert [c.name for c in kids] == ["vfi.upload", "vfi.upload",
                                          "vfi.forward", "vfi.output"]
        fwd = _children(kids[2])
        assert [c.name for c in fwd] == list(STAGES)
        assert [c.name for c in _children(fwd[2])] == [
            "vfi.features", "vfi.context", "vfi.motion"]
        fusion = [c for c in fwd if c.name == "vfi.fusion"]
        assert [c.name for c in _children(fusion[0])] == ["vfi.dcn"] * 3


def test_no_op_in_the_forward_outside_a_stage_span(traced):
    """Every aten op under `vfi.forward` lies in a stage span, but the
    dtype casts at the top of `EMAVFI.forward`."""
    _, events = traced
    loose = [e.name for e in events if not e.name.startswith("vfi.")
             and e.cpu_parent is not None
             and e.cpu_parent.name == "vfi.forward"]
    assert loose and set(loose) == {"aten::to"}
    assert len(loose) == 4     # two frames, two launches


def test_no_record_function_without_a_profiler(engine, frames, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert span("vfi.x") is span("vfi.y")
    engine.midpoints(*frames)
    engine.midpoints_sequence(np.concatenate([frames[0][:2],
                                              frames[1][1:2]]))


def test_span_is_a_record_function_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("vfi.x"):
            torch.ones(3).sum()
    assert isinstance(span("vfi.y"), type(profiling._NO_SPAN))
    names = [e.name for e in prof.events()]
    assert "vfi.x" in names and "aten::sum" in names


def test_midpoints_equal_with_and_without_a_profiler(engine, frames, traced):
    out, _ = traced
    assert out.dtype == torch.uint8 and out.shape == (B, H, W, 3)
    assert torch.equal(engine.midpoints(*frames), out)


def test_sequence_route_carries_its_spans(engine, frames):
    seq = np.concatenate([frames[0][:1], frames[1][:1]])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.midpoints_sequence(seq)
    launch = [e for e in prof.events() if e.name == "vfi.launch"]
    assert len(launch) == 1
    assert [c.name for c in _children(launch[0])] == [
        "vfi.upload", "vfi.forward", "vfi.output"]


def test_device_profile_span_table_on_the_cpu(engine, frames):
    res = device_profile(lambda: engine.midpoints(*frames), "cpu")
    rows = res["spans"]
    assert list(rows)[:4] == ["vfi.midpoints", "vfi.launch", "vfi.upload",
                              "vfi.forward"]
    assert rows["vfi.launch"]["count"] == 2
    assert rows["vfi.upload"]["count"] == 4
    assert rows["vfi.dcn"]["count"] == 6
    assert sum(r["host_self_ms"] for r in rows.values()) == pytest.approx(
        res["span_roots_ms"])
    assert res["span_roots_ms"] == rows["vfi.midpoints"]["host_ms"]
    # the root holds every op; each span's ops are its own and its children's
    assert rows["vfi.midpoints"]["ops"] == res["kernel_launches"]
    assert sum(r["ops_self"] for r in rows.values()) == res["kernel_launches"]
    assert rows["vfi.fusion"]["ops"] == (rows["vfi.fusion"]["ops_self"]
                                         + rows["vfi.dcn"]["ops"])
    assert sum(r["device_self_ms"] for r in rows.values()) == pytest.approx(
        res["device_kernel_ms"])
    assert res["span_unattributed_ms"] == 0 and res["ops_before_span"] == 0
    for r in rows.values():
        assert 0 <= r["idle_ms"] <= r["host_ms"] + 1e-6
    # no span is counted as an op
    assert not any(n.startswith("vfi.") for n, _ in res["top_kernels_ms"])


def _ev(name, a, b, dev=DeviceType.CPU, id_=0, parent=None, ann=False):
    return SimpleNamespace(name=name, device_type=dev, id=id_,
                           time_range=SimpleNamespace(start=a, end=b),
                           cpu_parent=parent, is_user_annotation=ann)


def test_span_table_links_kernels_through_their_launch_calls():
    """On the card a kernel belongs to the innermost span around the
    runtime call with its correlation id; the launch's own time places it,
    so a ctypes launch outside any aten op links too."""
    root = _ev("vfi.forward", 0.0, 100.0, ann=True)
    dcn = _ev("vfi.dcn", 20.0, 60.0, parent=root, ann=True)
    launches = [_ev("cudaLaunchKernel", 5.0, 6.0, id_=11, parent=root),
                _ev("cudaLaunchKernel", 30.0, 31.0, id_=12),   # ctypes
                _ev("cuLaunchKernel", 70.0, 71.0, id_=13, parent=root),
                _ev("cudaLaunchKernel", 120.0, 121.0, id_=14)]
    k = DeviceType.CUDA
    kernels = [_ev("conv2d_kernel<4>", 10.0, 25.0, k, 11),
               _ev("dcn_tile_kernel<16, 8>", 40.0, 70.0, k, 12),
               _ev("Memcpy DtoD", 72.0, 80.0, k, 13),
               _ev("elementwise_kernel", 125.0, 130.0, k, 14)]
    mirror = _ev("vfi.dcn", 40.0, 70.0, k, 0, ann=True)
    out = span_table([root, dcn, *launches, *kernels, mirror], kernels,
                     cuda=True)
    f, d = out["spans"]["vfi.forward"], out["spans"]["vfi.dcn"]
    # kernels run over [20, 25] and [40, 60] of the DCN's [20, 60]
    assert d == pytest.approx({"count": 1, "host_ms": 0.04,
                               "host_self_ms": 0.04, "device_ms": 0.03,
                               "device_self_ms": 0.03, "ops": 1,
                               "ops_self": 1, "idle_ms": 0.015})
    assert f["ops"] == 3 and f["ops_self"] == 2
    assert f["device_ms"] == pytest.approx(0.015 + 0.03 + 0.008)
    assert f["host_self_ms"] == pytest.approx(0.1 - 0.04)
    # kernels run over [10, 25] and [40, 70] of [0, 100]; the copy is idle
    assert f["idle_ms"] == pytest.approx(0.055)
    assert out["span_unattributed_ms"] == pytest.approx(0.005)
    assert out["span_roots_ms"] == pytest.approx(0.1)
    assert out["ops_before_span"] == 0


def test_profile_forward_engine_smoke(capsys):
    res = profile_forward.main(["--device", "cpu", "--smoke", "--engine",
                                "--ckpt", QOCC + ".npz", "--radius", "1",
                                "--conv_kernel", "pallas",
                                "--cascade_levels", "2", "--top", "3"])
    out = capsys.readouterr().out
    assert "spans (ms;" in out and "vfi.upload" in out
    rows = res["spans"]
    assert rows["vfi.midpoints"]["count"] == 1
    assert rows["vfi.cascade"]["count"] == 1
    assert sum(r["host_self_ms"] for r in rows.values()) == pytest.approx(
        res["span_roots_ms"])
    with pytest.raises(SystemExit):
        profile_forward.main(["--device", "cpu", "--smoke", "--engine"])
