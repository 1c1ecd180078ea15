"""The port's serving slice on the CPU, held against the JAX package's own
code: the micro-batcher (the fake-engine cases of tests/test_serve.py,
with engines that return numpy arrays and ones that return tensors), the
body codecs (byte-equal to `vfi_tpu.serve`'s), the HTTP server over a
tiny port engine (JAX `EMAVFI.init` weights, float32, exact DCN) against
the JAX engine, the engine's `io_uint8` and `midpoints_sequence`, the
exact unbounded DCN against `vfi_tpu.ops.deform_conv` (float32, JAX at
HIGHEST), the serve CLI at its defaults, and the port's PNG codec
against Pillow.

Tolerances: served midpoints within 1 level of 255 of the JAX engine (the
float32 engines agree to ~1e-6, which can move a rounding to uint8 by one
level); the exact DCN 1e-5 absolute and relative (float32 summation
order); the engine at 64x128 1e-4, as tests/test_torch_engine.py; PNG
decode and encode bit for bit."""

import functools
import http.client
import io
import json
import os
import re
import struct
import threading
import urllib.error
import urllib.request
import zlib
from collections import deque
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vfi_tpu.serve as jserve
from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.models.layers import ModulatedDeformConv as JMDC
from vfi_tpu.native import decode_png_rgb as jax_decode_png
from vfi_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from vfi_tpu.parallel import make_mesh
from vfi_tpu_torch import native
from vfi_tpu_torch.cli import serve as serve_cli
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.models.layers import ModulatedDeformConv
from vfi_tpu_torch.ops.deform_conv import deform_conv2d
from vfi_tpu_torch.serve import (RAW_CONTENT_TYPE, SEQ_CONTENT_TYPE,
                                 InterpolationServer, MicroBatcher,
                                 encode_pair_body, encode_raw_body,
                                 encode_seq_body, split_pair_body,
                                 split_raw_body, split_seq_body)
from vfi_tpu_torch.serve.batcher import _Request
from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
TINY = dict(mid_channels=8, num_blocks=1, bf16=False)
DCN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(x):
    return np.clip(np.asarray(x, np.float32) * 255.0 + 0.5, 0,
                   255).astype(np.uint8)


def _max_levels(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16)
                      - np.asarray(b).astype(np.int16)).max())


# -- micro-batcher ---------------------------------------------------------

class RecordingEngine:
    """midpoints = average of the pair, as a numpy array or a tensor;
    records every launched batch shape."""

    def __init__(self, kind="numpy", fail=False):
        self.batch_shapes = []
        self.kind = kind
        self.fail = fail
        self.lock = threading.Lock()

    def _out(self, x):
        return torch.from_numpy(np.asarray(x)) if self.kind == "tensor" else x

    def midpoints(self, f0, f1):
        with self.lock:
            self.batch_shapes.append(f0.shape)
        if self.fail:
            raise RuntimeError("engine down")
        return self._out((f0 + f1) / 2.0)

    def midpoints_sequence(self, frames):
        with self.lock:
            self.batch_shapes.append(("seq", frames.shape))
        return self._out((frames[:-1] + frames[1:]) / 2.0)


ENGINE_KINDS = ["numpy", "tensor"]


def _frames(rng, n, h=8, w=8):
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_coalesces_and_pads(rng, kind):
    eng = RecordingEngine(kind)
    mb = MicroBatcher(eng, max_batch=4, max_delay_ms=250.0)
    try:
        f = _frames(rng, 6)
        futs = [mb.submit(f[i], f[i + 3]) for i in range(3)]
        outs = [fu.result(timeout=10) for fu in futs]
        for i in range(3):
            assert isinstance(outs[i], np.ndarray)
            np.testing.assert_allclose(outs[i], (f[i] + f[i + 3]) / 2,
                                       rtol=1e-6)
    finally:
        mb.close()
    assert eng.batch_shapes == [(4, 8, 8, 3)]
    s = mb.stats.snapshot()
    assert s["requests"] == 3 and s["batches"] == 1 and s["padded_items"] == 1


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_pixel_budget_caps_launches(rng, kind):
    eng = RecordingEngine(kind)
    mb = MicroBatcher(eng, max_batch=4, max_delay_ms=250.0,
                      max_px_per_launch=128)
    try:
        assert mb.launch_size((8, 8)) == 2
        assert mb.launch_size((16, 16)) == 1
        assert mb.launch_size((2, 2)) == 4
        f = _frames(rng, 6)
        futs = [mb.submit(f[i], f[i + 3]) for i in range(3)]
        outs = [fu.result(timeout=10) for fu in futs]
        for i in range(3):
            np.testing.assert_allclose(outs[i], (f[i] + f[i + 3]) / 2,
                                       rtol=1e-6)
    finally:
        mb.close()
    assert eng.batch_shapes == [(2, 8, 8, 3), (2, 8, 8, 3)]
    s = mb.stats.snapshot()
    assert s["requests"] == 3 and s["batches"] == 2 and s["padded_items"] == 1


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_pixel_budget_warmup_shape(kind):
    eng = RecordingEngine(kind)
    mb = MicroBatcher(eng, max_batch=8, max_delay_ms=50.0,
                      max_px_per_launch=128)
    try:
        mb.warmup(8, 8)
    finally:
        mb.close()
    assert eng.batch_shapes == [(2, 8, 8, 3)]


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_shape_buckets(rng, kind):
    eng = RecordingEngine(kind)
    mb = MicroBatcher(eng, max_batch=4, max_delay_ms=50.0)
    try:
        a = _frames(rng, 2, h=8, w=8)
        b = _frames(rng, 2, h=16, w=8)
        fa = mb.submit(a[0], a[1])
        fb = mb.submit(b[0], b[1])
        assert fa.result(timeout=10).shape == (8, 8, 3)
        assert fb.result(timeout=10).shape == (16, 8, 3)
    finally:
        mb.close()
    assert sorted(s[1] for s in eng.batch_shapes) == [8, 16]
    assert all(s[0] == 4 for s in eng.batch_shapes)


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_full_batch_launches_immediately(rng, kind):
    eng = RecordingEngine(kind)
    mb = MicroBatcher(eng, max_batch=2, max_delay_ms=60_000.0)
    try:
        f = _frames(rng, 4)
        futs = [mb.submit(f[0], f[1]), mb.submit(f[2], f[3])]
        for fu in futs:
            fu.result(timeout=10)
    finally:
        mb.close()
    assert eng.batch_shapes == [(2, 8, 8, 3)]


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_propagates_engine_errors(rng, kind):
    eng = RecordingEngine(kind, fail=True)
    mb = MicroBatcher(eng, max_batch=2, max_delay_ms=1.0)
    try:
        f = _frames(rng, 2)
        fut = mb.submit(f[0], f[1])
        with pytest.raises(RuntimeError, match="engine down"):
            fut.result(timeout=10)
    finally:
        mb.close()
    assert mb.stats.snapshot()["errors"] == 1


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_rejects_bad_shapes(kind):
    mb = MicroBatcher(RecordingEngine(kind), max_batch=2)
    try:
        with pytest.raises(ValueError):
            mb.submit(np.zeros((8, 8, 3), np.float32),
                      np.zeros((8, 4, 3), np.float32))
        with pytest.raises(ValueError):
            mb.submit(np.zeros((8, 8), np.float32),
                      np.zeros((8, 8), np.float32))
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(np.zeros((8, 8, 3), np.float32),
                  np.zeros((8, 8, 3), np.float32))


def test_ready_bucket_earliest_deadline_first():
    """A saturated majority-shape bucket must not starve an older
    minority-shape request whose deadline already expired."""
    mb = MicroBatcher.__new__(MicroBatcher)
    mb.max_batch = 2
    mb.max_px = None
    mb.max_delay = 0.05
    mb._closed = False
    now = 100.0
    fresh = [_Request(None, None, Future(), t_submit=now - 0.001)
             for _ in range(2)]
    stale = _Request(None, None, Future(), t_submit=now - 1.0)
    mb._buckets = {(720, 1280): deque(fresh), (1080, 1920): deque([stale])}
    shape, soonest = mb._ready_bucket(now)
    assert shape == (1080, 1920) and soonest is None
    mb._buckets = {(720, 1280): deque(fresh)}
    shape, _ = mb._ready_bucket(now)
    assert shape == (720, 1280)


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_batcher_sequence_launch(rng, kind):
    eng = RecordingEngine(kind)
    b = MicroBatcher(eng, max_batch=4, max_delay_ms=5.0)
    try:
        fr = np.stack(_frames(rng, 5))
        out = b.interpolate_sequence(fr, timeout=10)
        assert isinstance(out, np.ndarray)
        np.testing.assert_allclose(out, (fr[:-1] + fr[1:]) / 2.0)
        assert ("seq", fr.shape) in eng.batch_shapes
        assert b.stats.requests == 4
    finally:
        b.close()


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_warmup_sequence_runs_the_seq_route(kind):
    eng = RecordingEngine(kind)
    server = InterpolationServer(eng, port=0).start()
    try:
        server.warmup([(9, 6, 8), (6, 8)])
        assert ("seq", (9, 6, 8, 3)) in eng.batch_shapes
        assert any(s[-3:] == (6, 8, 3) and len(s) == 4
                   for s in eng.batch_shapes if s[0] != "seq")
        with pytest.raises(ValueError, match=">= 2"):
            server.batcher.warmup_sequence(1, 6, 8)
    finally:
        server.shutdown()


# -- body codecs -----------------------------------------------------------

def test_body_encoders_match_the_reference(rng):
    a = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    fr = rng.integers(0, 256, (4, 6, 9, 3)).astype(np.uint8)
    assert encode_raw_body(a, b) == jserve.encode_raw_body(a, b)
    assert encode_seq_body(fr) == jserve.encode_seq_body(fr)
    assert (encode_pair_body(b"abc", b"defg")
            == jserve.encode_pair_body(b"abc", b"defg"))
    f0, f1 = split_raw_body(encode_raw_body(a, b))
    np.testing.assert_array_equal(f0, a)
    np.testing.assert_array_equal(f1, b)
    np.testing.assert_array_equal(split_seq_body(encode_seq_body(fr)), fr)
    assert split_pair_body(encode_pair_body(b"abc", b"defg")) == (b"abc",
                                                                  b"defg")


def _raw(h=6, w=9):
    return struct.pack(">HH", h, w) + bytes(2 * h * w * 3)


MALFORMED = [
    ("raw", b"\x00\x01"),
    ("raw", _raw()[:-1]),
    ("raw", _raw() + b"\x00"),
    ("seq", b"\x00"),
    ("seq", _raw()[:-1]),
    ("seq", _raw()[:4 + 6 * 9 * 3]),
    ("seq", struct.pack(">HH", 0, 9) + bytes(27)),
    ("pair", b"\x00\x00"),
    ("pair", encode_pair_body(b"abc", b"")),
    ("pair", struct.pack(">I", 0) + b"abc"),
]


@pytest.mark.parametrize("kind,body", MALFORMED)
def test_body_splitters_refuse_what_the_reference_refuses(kind, body):
    ours = {"raw": split_raw_body, "seq": split_seq_body,
            "pair": split_pair_body}[kind]
    ref = {"raw": jserve.split_raw_body, "seq": jserve.split_seq_body,
           "pair": jserve.split_pair_body}[kind]
    with pytest.raises(ValueError) as theirs:
        ref(body)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value)[:12])):
        ours(body)


def test_encoders_refuse_mismatched_frames(rng):
    a = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    with pytest.raises(ValueError, match="equal"):
        encode_raw_body(a, a[:4])
    with pytest.raises(ValueError):
        encode_seq_body(a[None])


# -- the served model ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """JAX `EMAVFI.init` weights of the tiny model (exact DCN and warp),
    the JAX float32 engine and the port's (float32 and io_uint8)."""
    model = JEMAVFI(mid_channels=8, num_blocks=1)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = jax.tree.map(np.asarray,
                          jax.jit(model.init)(jax.random.PRNGKey(0), x, x))
    mesh = make_mesh(devices=jax.devices()[:1])
    with jax.default_matmul_precision("highest"):
        jeng = JFI(params, mesh=mesh, **TINY)
        jeng_u8 = JFI(params, mesh=mesh, io_uint8=True, **TINY)
    return {"params": params, "jax": jeng, "jax_u8": jeng_u8,
            "f32": FrameInterpolator(params, device="cpu", **TINY),
            "u8": FrameInterpolator(params, device="cpu", io_uint8=True,
                                    **TINY)}


def _jax_mid(eng, f0, f1):
    with jax.default_matmul_precision("highest"):
        return np.asarray(eng.midpoints(f0, f1))


@pytest.fixture(scope="module")
def served(tiny):
    server = InterpolationServer(tiny["u8"], port=0, max_batch=4,
                                 max_delay_ms=20.0).start()
    yield server
    server.shutdown()


def _post(server, body, ctype="application/octet-stream", path=None):
    url = f"http://127.0.0.1:{server.port}{path or '/v1/interpolate'}"
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _pair(rng, h=16, w=24):
    a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return a, np.roll(a, (1, 2), axis=(0, 1))


def test_http_png_and_raw_routes_match_the_jax_engine(served, tiny, rng):
    """Both pair routes answer within 1 level of the JAX engine's float
    midpoint rounded to uint8, and raw equals PNG bit for bit."""
    a, b = _pair(rng)
    status, png = _post(served, encode_pair_body(native.encode_png_rgb(a),
                                                 native.encode_png_rgb(b)))
    assert status == 200
    got_png = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    np.testing.assert_array_equal(native.decode_png_rgb(png), got_png)
    status, raw = _post(served, encode_raw_body(a, b), RAW_CONTENT_TYPE)
    assert status == 200
    got_raw = np.frombuffer(raw, np.uint8).reshape(a.shape)
    np.testing.assert_array_equal(got_raw, got_png)
    want = _u8(_jax_mid(tiny["jax"], a[None] / np.float32(255),
                        b[None] / np.float32(255))[0])
    assert _max_levels(got_raw, want) <= 1


def test_http_sequence_route_matches_the_jax_engine(served, tiny, rng):
    fr = rng.integers(0, 256, (4, 16, 24, 3)).astype(np.uint8)
    conn = http.client.HTTPConnection("127.0.0.1", served.port, timeout=60)
    conn.request("POST", "/v1/interpolate", body=encode_seq_body(fr),
                 headers={"Content-Type": SEQ_CONTENT_TYPE})
    resp = conn.getresponse()
    data = resp.read()
    assert resp.status == 200, data
    mids = np.frombuffer(data, np.uint8).reshape(3, 16, 24, 3)
    f = fr.astype(np.float32) / 255.0
    want = _u8(_jax_mid(tiny["jax"], f[:-1], f[1:]))
    assert _max_levels(mids, want) <= 1


def test_http_concurrent_requests_batch(served, tiny, rng):
    pairs = [_pair(rng) for _ in range(5)]
    results = [None] * len(pairs)

    def worker(i):
        results[i] = _post(served, encode_raw_body(*pairs[i]),
                           RAW_CONTENT_TYPE)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(pairs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    direct = tiny["u8"].midpoints(np.stack([a for a, _ in pairs]),
                                  np.stack([b for _, b in pairs])).numpy()
    for i, (status, raw) in enumerate(results):
        assert status == 200
        got = np.frombuffer(raw, np.uint8).reshape(16, 24, 3)
        np.testing.assert_array_equal(got, direct[i])


def test_http_health_stats_and_errors(served, rng):
    base = f"http://127.0.0.1:{served.port}"
    health = json.loads(urllib.request.urlopen(base + "/healthz",
                                               timeout=10).read())
    assert health["status"] == "ok" and health["platform"] == "cpu"
    assert health["devices"] == 1 and health["max_batch"] == 4
    stats = json.loads(urllib.request.urlopen(base + "/stats",
                                              timeout=10).read())
    assert {"requests", "batches", "mean_batch_size"} <= set(stats)
    status, _ = _post(served, b"x", path="/nope")
    assert status == 404
    status, body = _post(served, b"junkbody")
    assert status == 400 and b"error" in body
    status, body = _post(served, b"\x00\x01\x00\x01junk", RAW_CONTENT_TYPE)
    assert status == 400 and b"raw body" in body
    a = np.zeros((16, 16, 3), np.uint8)
    status, body = _post(served, encode_pair_body(
        native.encode_png_rgb(a), native.encode_png_rgb(a[:8, :8])))
    assert status == 400 and b"differ" in body
    jpg = io.BytesIO()
    Image.fromarray(a).save(jpg, format="JPEG")
    status, body = _post(served, encode_pair_body(jpg.getvalue(),
                                                  jpg.getvalue()))
    assert status == 400 and b"PNG" in body


def test_http_engine_failure_is_a_500(rng):
    server = InterpolationServer(RecordingEngine(fail=True), port=0,
                                 max_batch=2, max_delay_ms=1.0).start()
    try:
        status, body = _post(server, encode_raw_body(*_pair(rng)),
                             RAW_CONTENT_TYPE)
    finally:
        server.shutdown()
    assert status == 500 and b"engine down" in body


# -- the engine's io_uint8 and sequence routes ------------------------------

def test_io_uint8_matches_float_engine_and_jax(tiny, rng):
    """uint8 in and out: within 1 level of the float engine quantized on
    the host and of the JAX io_uint8 engine; the batcher's coercion feeds
    float submissions to it losslessly."""
    eng = tiny["u8"]
    assert eng.io_dtype == np.uint8
    a = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    got = eng.midpoints(a, b)
    assert got.dtype == torch.uint8 and tuple(got.shape) == a.shape
    ref = tiny["f32"].midpoints(a / np.float32(255), b / np.float32(255))
    assert _max_levels(got, _u8(ref.numpy())) <= 1
    assert _max_levels(got, _jax_mid(tiny["jax_u8"], a, b)) <= 1
    mb = MicroBatcher(eng, max_batch=2, max_delay_ms=1.0)
    try:
        out = mb.interpolate(a[0] / np.float32(255), b[0] / np.float32(255),
                             timeout=60)
    finally:
        mb.close()
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, got[0].numpy())


def test_io_uint8_refuses_auto_scale(tiny):
    with pytest.raises(ValueError, match="io_uint8"):
        FrameInterpolator(tiny["params"], device="cpu", io_uint8=True,
                          flow_params={}, auto_scale=9.0, **TINY)


@pytest.mark.parametrize("engine", ["f32", "u8"])
def test_midpoints_sequence_matches_pairs(tiny, rng, engine):
    eng = tiny[engine]
    fr = rng.integers(0, 256, (4, 16, 24, 3)).astype(np.uint8)
    if engine == "f32":
        fr = fr.astype(np.float32) / 255.0
    seq = eng.midpoints_sequence(fr)
    pairs = eng.midpoints(fr[:-1], fr[1:])
    assert seq.dtype == pairs.dtype and seq.shape == pairs.shape
    if engine == "u8":
        assert _max_levels(seq, pairs) <= 1
    else:
        np.testing.assert_allclose(seq.numpy(), pairs.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match=">= 2"):
        eng.midpoints_sequence(fr[:1])


@pytest.mark.parametrize("budget,pair_launches,forwards", [
    (300, 4, [1, 1, 1, 1]), (600, 0, [1, 1, 1, 1]), (900, 0, [2, 2])])
def test_sequence_guard_chunks_and_never_recurses(tiny, rng, budget,
                                                  pair_launches, forwards):
    """256 px a frame, five frames. Budget 300 < two frames: the pairs go
    through midpoints, whose guard splits by pairs (one a launch) and
    never recurses; 600: chunks of 2 frames overlapping by one; 900:
    chunks of 3. Each result equals the unguarded one."""
    fr = rng.uniform(0, 1, (5, 16, 16, 3)).astype(np.float32)
    ref = FrameInterpolator(tiny["params"], device="cpu",
                            max_px_per_launch=None,
                            **TINY).midpoints(fr[:-1], fr[1:])
    eng = FrameInterpolator(tiny["params"], device="cpu",
                            max_px_per_launch=budget, **TINY)
    seen, pairs = [], []
    forward, launch = eng._forward, eng._midpoints_launch

    def counted_forward(x, y):
        seen.append(x.shape[0])
        return forward(x, y)

    def counted_launch(*a, **k):
        pairs.append(1)
        return launch(*a, **k)

    eng._forward, eng._midpoints_launch = counted_forward, counted_launch
    got = eng.midpoints_sequence(fr)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)
    assert seen == forwards and len(pairs) == pair_launches


# -- the exact unbounded DCN -------------------------------------------------

DCN_CASES = [
    # b, h, w, cin, cout, k, stride, padding, dilation, offset groups,
    # weight groups, mask
    (2, 9, 11, 6, 5, 3, 1, 1, 1, 1, 1, True),
    (2, 9, 11, 6, 5, 3, 1, 1, 1, 1, 1, False),
    (1, 12, 10, 8, 6, 3, 2, 1, 1, 2, 2, True),
    (1, 10, 13, 4, 4, 3, 1, 2, 2, 1, 1, False),
    (1, 7, 9, 6, 4, 1, 1, 0, 1, 3, 1, True),
    (1, 8, 8, 67, 67, 3, 1, 1, 1, 1, 1, True),
]


@pytest.mark.parametrize("case", DCN_CASES)
def test_exact_deform_conv2d_matches_jax(case):
    """Offsets of up to +-6 px on frames of 7-13 px: most taps land past
    the edge, where the zero padding rides on the corner weights."""
    b, h, w, cin, cout, k, s, p, d, og, g, with_mask = case
    rng = np.random.default_rng(sum(case))
    ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * p - d * (k - 1) - 1) // s + 1
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    off = rng.uniform(-6, 6, (b, ho, wo, 2 * og * k * k)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, ho, wo, og * k * k)).astype(np.float32)
            if with_mask else None)
    wt = rng.standard_normal((k, k, cin // g, cout)).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    jdc = jax.jit(functools.partial(jax_deform_conv2d, stride=s, padding=p,
                                    dilation=d,
                                    precision=jax.lax.Precision.HIGHEST))
    ref = np.asarray(jdc(jnp.asarray(x), jnp.asarray(off),
                         None if mask is None else jnp.asarray(mask),
                         jnp.asarray(wt), jnp.asarray(bias)))
    got = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                        None if mask is None else torch.from_numpy(mask),
                        torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(bias), s, p, d)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=DCN_TOL, rtol=DCN_TOL)


def test_exact_deform_conv2d_refuses_a_wrong_offset_grid():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="offset spatial shape"):
        deform_conv2d(x, torch.zeros(1, 8, 8, 18), None,
                      torch.zeros(4, 4, 3, 3), stride=2)


def test_unbounded_dcn_layer_reads_the_offsets_as_jax_does():
    """The layer's offset conv output splits static | mask | dynamic and
    the offsets are cat(static, dynamic) in torchvision's (dy, dx) order:
    random offset-conv weights give offsets past 4 px and past the edge."""
    rng = np.random.default_rng(4)
    c, h, w = 6, 10, 12
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    jm = JMDC(features=c, max_offset=None)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x)))
    p["params"]["offset_conv"]["kernel"] = (
        rng.standard_normal((3, 3, c, 27)) * 1.5).astype(np.float32)
    p["params"]["offset_conv"]["bias"] = (
        rng.standard_normal((27,)) * 3.0).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    tm = ModulatedDeformConv(c, None)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        raw = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), tm.offset_conv.weight,
            tm.offset_conv.bias, padding=1)
        assert raw.abs().max() > 4.0
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def qocc():
    return load_params_npz(QOCC + ".npz"), load_params_npz(QOCC + ".flow.npz")


def test_engine_with_the_exact_dcn_matches_jax(qocc):
    """qocc with its flow prior and cascade, the exact DCN
    (dcn_max_offset=None) and the bounded warp, float32 at 64x128."""
    kw = dict(flow_params=qocc[1], bf16=False, warp_max_flow=16,
              cascade_levels=2)
    rng = np.random.default_rng(11)
    f0 = rng.uniform(0, 1, (1, 64, 128, 3)).astype(np.float32)
    f1 = np.roll(f0, (3, -4), axis=(1, 2))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JFI(qocc[0], mesh=make_mesh(
            devices=jax.devices()[:1]), **kw).midpoints(f0, f1))
    got = FrameInterpolator(qocc[0], device="cpu", **kw).midpoints(f0, f1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


# -- the serve CLI ----------------------------------------------------------

def test_serve_cli_answers_at_the_jax_cli_defaults(rng, capsys):
    """`--model_path qocc --flow_prior --device cpu`: exact DCN, unbounded
    warp, io_uint8, the batcher's defaults; --warmup runs both routes."""
    server = serve_cli.build_server([
        "--model_path", QOCC + ".npz", "--flow_prior", "--device", "cpu",
        "--port", "0", "--warmup", "16x24,2@16x24"])
    assert "16x24 bucket (batch 8)" in capsys.readouterr().out
    eng = server.batcher.engine
    assert eng.io_dtype == np.uint8 and eng.model.warp_max_flow is None
    assert eng.model.fusion_dcn0.max_offset is None
    assert server.batcher.max_px == 5_000_000
    server.start()
    try:
        status, raw = _post(server, encode_raw_body(*_pair(rng)),
                            RAW_CONTENT_TYPE)
    finally:
        server.shutdown()
    assert status == 200 and len(raw) == 16 * 24 * 3


# -- the PNG codec ----------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_png_encoder_reads_back_bit_for_bit(rng, level):
    frame = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    frame[:5] = 7                               # a run zlib can shrink
    data = native.encode_png_rgb(frame, level)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), frame)
    np.testing.assert_array_equal(jax_decode_png(data), frame)
    np.testing.assert_array_equal(native.decode_png_rgb(data), frame)


def test_png_encoder_refuses_other_frames():
    with pytest.raises(ValueError):
        native.encode_png_rgb(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        native.encode_png_rgb(np.zeros((4, 4), np.uint8))


PIL_WRITES = [("1", None), ("L", None), ("I;16", None), ("LA", None),
              ("RGB", None), ("RGBA", None), ("P", None), ("P", 1),
              ("P", 2), ("P", 4)]


@pytest.mark.parametrize("mode,bits", PIL_WRITES)
def test_png_decoder_matches_pil_on_what_pil_writes(tmp_path, mode, bits):
    rng = np.random.default_rng(5)
    if mode == "I;16":
        arr = rng.integers(0, 1000, (19, 27)).astype(np.uint16)
        arr[::3] = rng.integers(0, 65536, (7, 27))
        img = Image.fromarray(arr)
    else:
        base = (np.add.outer(np.arange(19), np.arange(27)) * 5 % 256)
        arr = (base[..., None] + rng.integers(0, 9, (19, 27, 4))) % 256
        img = Image.fromarray(arr.astype(np.uint8), "RGBA")
        img = (img.convert("RGB").quantize(colors=2 ** bits) if bits
               else img.convert(mode))
    path = tmp_path / "x.png"
    img.save(path, **({"bits": bits} if bits else {}))
    ref = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(native.decode_png_rgb(path.read_bytes()),
                                  ref)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack(rows: np.ndarray, depth: int) -> list:
    """(n, samples) ints -> each row's bytes at the bit depth."""
    out = []
    for r in rows:
        if depth >= 8:
            out.append(r.astype(">u2" if depth == 16 else np.uint8).tobytes())
            continue
        per = 8 // depth
        r = np.concatenate([r, np.zeros((-len(r)) % per, r.dtype)])
        r = r.reshape(-1, per).astype(np.int64)
        packed = sum(r[:, k] << (8 - depth * (k + 1)) for k in range(per))
        out.append(packed.astype(np.uint8).tobytes())
    return out


def _filter(rows: list, unit: int, rng) -> bytes:
    """Each scanline under a random filter type (None, Sub, Up, Average,
    Paeth), encoded against the unfiltered previous row."""
    out, prev = b"", np.zeros(len(rows[0]), np.int64)
    for row in rows:
        cur = np.frombuffer(row, np.uint8).astype(np.int64)
        left = np.concatenate([np.zeros(unit, np.int64), cur])[:len(cur)]
        upleft = np.concatenate([np.zeros(unit, np.int64), prev])[:len(cur)]
        f = int(rng.integers(0, 5))
        if f == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = (np.zeros_like(cur), left, prev, (left + prev) // 2)[f]
        out += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return out


def _write_png(samples, color_type, depth, interlace, palette, rng) -> bytes:
    """A PNG of (h, w, c) samples at any depth, Adam7 or not, every
    scanline under a random filter."""
    h, w, c = samples.shape
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub.reshape(sub.shape[0], -1), depth),
                           max(1, c * depth // 8), rng)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return data + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


WRITER_CASES = [(ct, d, il) for ct, depths in (
    (0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
    (6, (8, 16))) for d in depths for il in (False, True)]


@pytest.mark.parametrize("color_type,depth,interlace", WRITER_CASES)
def test_png_decoder_matches_pil_on_every_depth_and_adam7(
        tmp_path, color_type, depth, interlace):
    """Every colour type at every depth, Adam7 or not, on sizes that leave
    passes empty: bit-equal to Pillow's convert("RGB"), which saturates
    16-bit gray, keeps the high byte of the other 16-bit types, and reads
    a palette index past the last entry as black."""
    rng = np.random.default_rng(color_type * 100 + depth * 2 + interlace)
    for h, w in ((1, 1), (3, 7), (13, 11)):
        s = rng.integers(0, 1 << depth, (h, w, CHANNELS[color_type]))
        if color_type == 0 and depth == 16:
            s[::2] %= 400                 # values on both sides of 255
        palette = (rng.integers(0, 256, (max(1, (1 << depth) - 2), 3))
                   if color_type == 3 else None)
        path = tmp_path / f"x{h}.png"
        path.write_bytes(_write_png(s, color_type, depth, interlace,
                                    palette, rng))
        ref = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(
            native.decode_png_rgb(path.read_bytes()), ref)


def test_png_decoder_refuses_a_jpeg():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="only PNG"):
        native.decode_png_rgb(buf.getvalue())


def test_png_decoder_builds_once_under_concurrent_first_use(tmp_path,
                                                            monkeypatch):
    """The server's handler threads decode at once: the first decodes of a
    process, each finding no library yet, build it once and all succeed
    (they used to race on one temporary file and answer 400)."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    frame = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    data = native.encode_png_rgb(frame)
    start = threading.Barrier(6)
    results = [None] * 6

    def decode(i):
        start.wait()
        try:
            results[i] = native.decode_png_rgb(data)
        except Exception as e:  # noqa: BLE001 - reported below
            results[i] = e

    threads = [threading.Thread(target=decode, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for r in results:
        assert isinstance(r, np.ndarray), r
        np.testing.assert_array_equal(r, frame)
    assert len(list(tmp_path.glob("*/*.so"))) == 1
