"""The engine's CUDA-graph cache, on the CPU: the cascade's flow scale
(written with no host-to-device copy, so that a graph may capture it)
against the old `torch.tensor` form, bit for bit; the routes that must
run eager (the CPU, spatial, `broadcast_inputs`, a data mesh, frames in
another dtype, a launch inside another capture); the key's backend flags;
and the cache's capture / replay / eviction bookkeeping over a stand-in
for the graph. The graphs themselves run on the card
(`tests/test_torch_cuda.py -k graph`)."""

import numpy as np
import pytest
import torch

import vfi_tpu_torch.models.ema_vfi as ema_vfi
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.infer import pair
from vfi_tpu_torch.models.ema_vfi import EMAVFI
from vfi_tpu_torch.parallel.mesh import make_mesh
from vfi_tpu_torch.utils.convert import params_to_jax

H, W = 21, 27


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(seed=0, **kw):
    torch.manual_seed(seed)
    return EMAVFI(mid_channels=8, num_blocks=1, dcn_max_offset=1,
                  warp_max_flow=4, cascade_levels=2, **kw).eval()


@pytest.fixture(scope="module")
def tiny_params():
    """A random tiny EMAVFI in the JAX layout the engine loads."""
    return params_to_jax(_tiny().state_dict())


def _frames(b, seed=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    f0 = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
    f1 = np.roll(f0, (1, 2), axis=(1, 2))
    if dtype == np.float32:
        return f0.astype(np.float32) / 255, f1.astype(np.float32) / 255
    return f0, f1


@pytest.mark.parametrize("h,w,dtype", [(21, 27, None), (37, 45, None),
                                       (37, 45, torch.bfloat16)])
def test_cascade_scale_is_bit_identical_to_the_tensor_form(
        monkeypatch, h, w, dtype):
    """At sizes whose coarse grid does not divide them (w / cw and h / ch
    are not exact), the flow the cascade warps by is the resized flow
    times `torch.tensor([w / cw, h / ch], float32)` bit for bit, and the
    midpoints equal those of a forward that warps by that product."""
    model = _tiny(dtype=dtype)
    rng = np.random.default_rng(h)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (2, h, w, 3)).astype(
        np.float32)) for _ in range(2))
    resized, warped, real_resize, real_warp = [], [], \
        ema_vfi.resize_bilinear, ema_vfi.warp

    def resize(x, size, *args):
        out = real_resize(x, size, *args)
        if x.shape[-1] == 2 and x.dtype == torch.float32:
            resized.append(out.clone())     # the flow, before its scale
        return out

    def warp_old_form(img, flow):
        if not warped:                      # the cascade's warp
            ch, cw = -(-h // 2), -(-w // 2)
            old = resized[-1] * torch.tensor([w / cw, h / ch],
                                             dtype=torch.float32)
            assert torch.equal(flow, old)
            warped.append(flow)
            flow = old
        return real_warp(img, flow)

    monkeypatch.setattr(ema_vfi, "resize_bilinear", resize)
    with torch.no_grad():
        new = model(a, b)
        monkeypatch.setattr(ema_vfi, "warp", warp_old_form)
        old = model(a, b)
    assert len(warped) == 1
    assert not float(w / -(-w // 2)).is_integer()
    assert torch.equal(new, old)


def _fake_card(monkeypatch, eng, capturing=False):
    """The engine's state as on a card, on the CPU: its device reads
    cuda:0 and no stream is capturing (unless `capturing`)."""
    eng.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)


@pytest.mark.parametrize("route", ["graph", "cpu", "spatial", "broadcast",
                                   "mesh", "float_frames", "capturing"])
def test_routes_that_cannot_be_captured_have_no_key(monkeypatch,
                                                    tiny_params, route):
    """The graph key is read off the engine's own state: a launch on a
    card of the plain route has one; the CPU, spatial (and with it
    `broadcast_inputs`), a mesh with two 'data' rows, frames that are not
    in the io dtype, and a launch inside another capture have none."""
    mesh = (make_mesh(devices=[torch.device("cpu")] * 2)
            if route == "mesh" else None)
    eng = FrameInterpolator(tiny_params, device="cpu", io_uint8=True,
                            mesh=mesh)
    if route != "cpu":
        _fake_card(monkeypatch, eng, capturing=route == "capturing")
    if route in ("spatial", "broadcast"):
        eng.spatial = True
        eng.broadcast_inputs = route == "broadcast"
    f0, _ = _frames(2, dtype=np.float32 if route == "float_frames"
                    else np.uint8)
    key = eng._graph_key(f0)
    if route == "graph":
        assert key[:3] == ((2, H, W, 3), torch.uint8, eng.device)
        assert eng._graph_key(torch.from_numpy(f0)) == key
        assert eng._graph_key(f0, scaled=True) != key
    else:
        assert key is None


@pytest.mark.parametrize("flag", ["matmul", "cudnn"])
def test_the_key_changes_with_a_tf32_flag(monkeypatch, tiny_params, flag):
    eng = FrameInterpolator(tiny_params, device="cpu", io_uint8=True)
    _fake_card(monkeypatch, eng)
    f0, _ = _frames(1)
    backend = (torch.backends.cuda.matmul if flag == "matmul"
               else torch.backends.cudnn)
    was = backend.allow_tf32
    try:
        backend.allow_tf32 = False
        off = eng._graph_key(f0)
        backend.allow_tf32 = True
        on = eng._graph_key(f0)
    finally:
        backend.allow_tf32 = was
    assert off != on and off[:4] == on[:4]


@pytest.mark.parametrize("kw", [{}, {"tta": True}, {"mesh": 2},
                                {"auto_scale": 0.0}])
def test_the_cpu_runs_every_launch_eager(tiny_params, kw):
    """On the CPU every launch runs eager (two guard launches a call, three
    calls of one shape, and the sequence route), whatever the route, and
    the midpoints of a shape repeat bit for bit."""
    if kw.get("mesh"):
        kw = {"mesh": make_mesh(devices=[torch.device("cpu")] * 2)}
    if "auto_scale" in kw:
        kw = {**kw, "flow_params": params_to_jax(
            _flow_state()), "io_uint8": False}
    io_uint8 = kw.pop("io_uint8", True)
    eng = FrameInterpolator(tiny_params, device="cpu", io_uint8=io_uint8,
                            max_px_per_launch=2 * H * W, **kw)
    f0, f1 = _frames(4, dtype=np.uint8 if io_uint8 else np.float32)
    outs = [eng.midpoints(f0, f1) for _ in range(3)]
    eng.midpoints_sequence(np.concatenate([f0[:1], f1[:1]]))
    assert eng.graph_stats == {"captured": 0, "replayed": 0, "eager": 7,
                               "evicted": 0}
    assert not eng._graphs
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def _flow_state():
    from vfi_tpu_torch.models.flownet import SimpleFlowNet

    torch.manual_seed(1)
    return SimpleFlowNet(in_channels=3, mid_channels=32,
                         levels=3).state_dict()


class _StandIn:
    """A captured launch's stand-in: replay writes the midpoints of the
    inputs' current values (f0 // 2 + f1 // 2) into the static output."""

    def __init__(self, g):
        self.g, self.replays = g, 0

    def replay(self):
        self.replays += 1
        self.g.out.copy_(self.g.in0 // 2 + self.g.in1 // 2)


def _stand_in_capture(eng, key, f0, f1):
    """The launch's eager midpoints and a stand-in graph (or, for frames
    whose first pixel is 255, a failed capture)."""
    g = pair._Graph()
    g.in0, g.in1 = (torch.as_tensor(x).clone() for x in (f0, f1))
    g.out = torch.empty_like(g.in0)
    g.kept = []
    g.graph = _StandIn(g)
    out = g.in0 // 2 + g.in1 // 2
    return out, (pair._NO_GRAPH if g.in0.flatten()[0] == 255 else g)


def test_capture_replay_and_eviction_bookkeeping(monkeypatch, tiny_params):
    """A key's first launch runs eager, its second is captured, the later
    ones replay with the new frames; a launch under the profiler is never
    captured; every replay's midpoints are a copy, not the static output;
    past the cap the least recently used key goes, and comes back eager,
    then captured; a key whose capture failed runs eager from then on."""
    eng = FrameInterpolator(tiny_params, device="cpu", io_uint8=True)
    _fake_card(monkeypatch, eng)
    monkeypatch.setattr(FrameInterpolator, "_capture", _stand_in_capture)
    monkeypatch.setattr(pair, "GRAPH_KEYS", 2)
    a, b = _frames(2)
    key = eng._graph_key(a)
    assert eng._replay(key, a, b) is None           # first: eager
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert eng._replay(key, a, b) is None       # never under a profiler
    got = [eng._replay(key, a, b)]                  # captured
    a2, b2 = _frames(2, seed=6)
    got.append(eng._replay(key, a2, b2))            # replayed, new frames
    assert eng.graph_stats == {"captured": 1, "replayed": 1, "eager": 0,
                               "evicted": 0}
    want = torch.from_numpy(a // 2 + b // 2)
    assert torch.equal(got[0], want)                # not overwritten
    assert torch.equal(got[1], torch.from_numpy(a2 // 2 + b2 // 2))
    g = eng._graphs[key]
    assert got[1] is not g.out and got[1].data_ptr() != g.out.data_ptr()
    assert g.graph.replays == 1
    c, d = _frames(1, seed=4)
    e, f = _frames(3, seed=5)
    eng._replay(eng._graph_key(c), c, d)            # a second key
    eng._replay(key, a, b)                          # the first is recent
    eng._replay(eng._graph_key(e), e, f)            # drops the second
    assert list(eng._graphs) == [key, eng._graph_key(e)]
    assert eng.graph_stats["evicted"] == 0          # it held no graph
    eng._replay(eng._graph_key(c), c, d)            # drops the first
    assert key not in eng._graphs and eng.graph_stats["evicted"] == 1
    assert eng._replay(key, a, b) is None           # back: eager again
    assert torch.equal(eng._replay(key, a, b), want)   # and captured
    assert eng.graph_stats["captured"] == 2
    x, y = _frames(4, seed=7)
    x[0, 0, 0, 0] = 255                             # its capture fails
    monkeypatch.setattr(pair, "GRAPH_KEYS", 8)
    kx = eng._graph_key(x)
    assert eng._replay(kx, x, y) is None
    eager = eng.graph_stats["eager"]
    got = eng._replay(kx, x, y)                     # the eager midpoints
    assert torch.equal(got, torch.from_numpy(x // 2 + y // 2))
    assert eng._graphs[kx] is pair._NO_GRAPH
    assert eng.graph_stats["eager"] == eager + 1
    assert eng._replay(kx, x, y) is None            # eager from then on
