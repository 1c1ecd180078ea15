"""The port's video up-conversion on the CPU, held against the JAX
package's own code with the same weights (JAX `EMAVFI.init` of the tiny
model, mid_channels=8, one block, exact DCN) and the same seed-made
inputs, float32 on both sides (JAX matmuls at HIGHEST):

- `pick_interpolation_factor`: equal to JAX's over a grid of rates that
  includes the 24 fps tie and the clamps;
- `FrameInterpolator.recursive`: frames within RECURSIVE_TOL of JAX's at
  factors 1-5, with and without `reference_compat`; with `io_uint8`
  within 1 level of 255 (the float32 engines agree to ~1e-7, which can
  move a rounding to uint8 by one level);
- `video_io.to_float` / `to_u8`: bit-equal to JAX's `_to_float` /
  `_to_u8`;
- `interpolate_video` against JAX's on a small MJPG file written with
  cv2 (factors 1 and 3, frame_interval 2, scale 0.5, reference_compat):
  equal stats; the frames handed to the writer, captured by a recording
  writer on both sides, equal in count and order; source frames
  bit-equal; inserted frames within 1 level, at least 99.9% of them
  exact (truncation to uint8 turns a 1e-7 difference into a level where
  a value sits on a level's edge);
- `interpolate_videos` over 3 clips of two sizes: per-clip stats equal to
  JAX's, each clip's frames within 1 level of the port's single-clip run.
"""

import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.infer.multi import interpolate_videos as jax_interpolate_videos
from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.infer.pair import \
    pick_interpolation_factor as jax_pick_interpolation_factor
from vfi_tpu.infer.video import _to_float as jax_to_float
from vfi_tpu.infer.video import _to_u8 as jax_to_u8
from vfi_tpu.infer.video import interpolate_video as jax_interpolate_video
from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.parallel import make_mesh
from vfi_tpu_torch.infer import FrameInterpolator, pick_interpolation_factor
from vfi_tpu_torch.infer import video_io
from vfi_tpu_torch.infer.multi import SharedEngine, interpolate_videos
from vfi_tpu_torch.infer.video import interpolate_video
from vfi_tpu_torch.serve import MicroBatcher

TINY = dict(mid_channels=8, num_blocks=1, bf16=False)
RECURSIVE_TOL = 2e-5
# Inserted frames after truncation to uint8: at most this many levels
# apart, and at least this share of their values equal.
LEVELS = 1
EXACT_SHARE = 0.999


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """The tiny model's JAX `EMAVFI.init` weights; the JAX engine and the
    port's, float32 and io_uint8, each plain and reference_compat."""
    model = JEMAVFI(mid_channels=8, num_blocks=1)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = jax.tree.map(np.asarray,
                          jax.jit(model.init)(jax.random.PRNGKey(0), x, x))
    mesh = make_mesh(devices=jax.devices()[:1])
    out = {"params": params}
    for io in ("f32", "u8"):
        for compat in (False, True):
            kw = dict(TINY, io_uint8=io == "u8", reference_compat=compat)
            with jax.default_matmul_precision("highest"):
                out["jax", io, compat] = JFI(params, mesh=mesh, **kw)
            out["port", io, compat] = FrameInterpolator(params, device="cpu",
                                                        **kw)
    return out


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)
    f0 = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    return f0, np.roll(f0, (2, -3), axis=(1, 2))


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int16)
                      - np.asarray(b).astype(np.int16)).max())


# -- the engine ------------------------------------------------------------

@pytest.mark.parametrize("src_fps", [1.0, 7.5, 12.0, 15.0, 23.976, 24.0,
                                     25.0, 29.97, 30.0, 50.0, 59.94, 60.0,
                                     120.0])
def test_pick_interpolation_factor_matches_jax(src_fps):
    """Auto mode at every max factor 1-6, and targets that round, clamp
    at 1 and clamp at the max."""
    for max_factor in range(1, 7):
        for target in (None, 30.0, 48.0, 60.0, 90.0, 120.0, 240.0, 1000.0):
            assert (pick_interpolation_factor(src_fps, target, max_factor)
                    == jax_pick_interpolation_factor(src_fps, target,
                                                     max_factor))
    assert pick_interpolation_factor(24.0, None) == (1, 48.0)   # the tie
    assert pick_interpolation_factor(15.0, None) == (3, 60.0)


@pytest.mark.parametrize("compat", [False, True], ids=["bisect", "compat"])
@pytest.mark.parametrize("factor", [1, 2, 3, 4, 5])
def test_recursive_matches_jax(engines, pair, factor, compat):
    ref = _jax(engines["jax", "f32", compat].recursive, *pair, factor)
    got = engines["port", "f32", compat].recursive(*pair, factor)
    assert len(got) == len(ref) == factor
    for g, r in zip(got, ref):
        assert isinstance(g, torch.Tensor) and g.shape == pair[0].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=RECURSIVE_TOL, rtol=0)
    if compat:
        assert all(g is got[0] for g in got)
    elif factor == 3:
        assert not np.allclose(got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("factor", [1, 3, 4])
def test_recursive_io_uint8_within_a_level_of_jax(engines, pair, factor):
    """With io_uint8 the uint8 midpoint of a level feeds the next, on both
    sides."""
    u8 = [np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8) for f in pair]
    ref = _jax(engines["jax", "u8", False].recursive, *u8, factor)
    got = engines["port", "u8", False].recursive(*u8, factor)
    assert len(got) == len(ref) == factor
    for g, r in zip(got, ref):
        assert g.dtype == torch.uint8
        assert _levels(g.numpy(), np.asarray(r)) <= LEVELS


def test_recursive_feeds_each_level_the_tensor_it_made(engines, pair):
    """Factor 3 makes three `midpoints` calls; the second and third take
    the first's result as the tensor it is, with no host round trip."""
    eng = engines["port", "f32", False]
    calls = []
    real = FrameInterpolator.midpoints

    def spy(self, f0, f1):
        out = real(self, f0, f1)
        calls.append((f0, f1, out))
        return out

    try:
        FrameInterpolator.midpoints = spy
        eng.recursive(*pair, 3)
    finally:
        FrameInterpolator.midpoints = real
    assert len(calls) == 3
    mid = calls[0][2]
    assert calls[1][1] is mid and calls[2][0] is mid


def test_recursive_of_no_frames(engines, pair):
    assert engines["port", "f32", False].recursive(*pair, 0) == []


# -- frame conversion ------------------------------------------------------

@pytest.mark.parametrize("size_wh", [(48, 32), (24, 16), (50, 30)],
                         ids=["native", "half", "odd"])
@pytest.mark.parametrize("swap_rgb", [True, False])
def test_to_float_matches_jax(size_wh, swap_rgb):
    frame = np.random.default_rng(3).integers(0, 256, (32, 48, 3)).astype(
        np.uint8)
    got = video_io.to_float(frame, size_wh, swap_rgb)
    ref = jax_to_float(frame, size_wh, swap_rgb)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("swap_rgb", [True, False])
def test_to_u8_matches_jax(swap_rgb, compat):
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.1, 1.1, (32, 48, 3)).astype(np.float32)
    x[0, :, 0] = np.arange(48) / 47.0        # levels' edges
    got = video_io.to_u8(x, swap_rgb, compat)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_to_u8(x, swap_rgb, compat))


def test_source_frames_survive_the_round_trip():
    """Every uint8 level survives to_float then to_u8 (truncation):
    written source frames are the decoded ones."""
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, 2)
    back = video_io.to_u8(video_io.to_float(levels, (16, 16), True), True,
                          False)
    np.testing.assert_array_equal(back, levels)


def test_capture_property_ids_are_cv2s():
    assert (video_io.CAP_PROP_FRAME_WIDTH, video_io.CAP_PROP_FRAME_HEIGHT,
            video_io.CAP_PROP_FPS, video_io.CAP_PROP_FRAME_COUNT) == (
        cv2.CAP_PROP_FRAME_WIDTH, cv2.CAP_PROP_FRAME_HEIGHT,
        cv2.CAP_PROP_FPS, cv2.CAP_PROP_FRAME_COUNT)


def test_file_functions_name_cv2_when_it_is_missing(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    for call in (lambda: video_io.open_capture("x.avi"),
                 lambda: video_io.open_writer("y.avi", "MJPG", 30.0, (8, 8)),
                 lambda: video_io.to_float(np.zeros((4, 4, 3), np.uint8),
                                           (2, 2), True)):
        with pytest.raises(ImportError, match="cv2.*`video`"):
            call()
    # no resize: no cv2 needed
    video_io.to_float(np.zeros((4, 4, 3), np.uint8), (4, 4), True)


# -- the single-clip pipeline ----------------------------------------------

class Recorder:
    """A stand-in for `cv2.VideoWriter` that keeps every frame written,
    by output path."""

    frames: dict = {}
    lock = threading.Lock()

    def __init__(self, path, fourcc=None, fps=None, size=None):
        self.path = path
        with Recorder.lock:
            Recorder.frames[path] = []

    def isOpened(self):
        return True

    def write(self, frame):
        Recorder.frames[self.path].append(np.array(frame, copy=True))

    def release(self):
        pass


def _write_clip(path, n, h, w, fps, seed):
    """An MJPG clip of n (h, w) frames: a smooth texture moving 2 px a
    frame."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 4, w // 4, 3)).astype(np.float32)
    base = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (w, h))
    for i in range(n):
        writer.write(np.clip(np.roll(base, 2 * i, axis=1), 0, 255).astype(
            np.uint8))
    writer.release()


def _decoded(path, frame_interval, size_wh):
    """The source frames the pipeline uses, as uint8 BGR at size_wh."""
    cap = cv2.VideoCapture(path)
    out, i = [], 0
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        if i % frame_interval == 0:
            if (fr.shape[1], fr.shape[0]) != size_wh:
                fr = cv2.resize(fr, size_wh)
            out.append(fr)
        i += 1
    cap.release()
    return out


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "in.avi")
    _write_clip(path, 7, 64, 96, 30.0, seed=8)
    return path


VIDEO_CASES = {
    "factor1": dict(scale=0.5),
    "factor3_interval2": dict(target_fps=120.0, frame_interval=2, scale=0.5),
    "factor3_compat": dict(target_fps=120.0, scale=0.5, reference_compat=True),
    "factor1_compat": dict(scale=0.5, reference_compat=True),
    "factor4_native": dict(target_fps=150.0, scale=1.0, batch_pairs=3),
}


def _source_slots(n_src, factor, compat):
    """Indices of the written frames that are source frames, in order."""
    if compat:      # per pair: factor midpoints, then its first frame
        return [i * (factor + 1) + factor for i in range(n_src - 1)] + [
            (n_src - 1) * (factor + 1)]
    return [i * (factor + 1) for i in range(n_src)]


@pytest.mark.parametrize("case", list(VIDEO_CASES))
def test_interpolate_video_matches_jax(engines, clip, monkeypatch, case):
    kw = {"batch_pairs": 2, **VIDEO_CASES[case]}
    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    ref_stats = _jax(jax_interpolate_video, clip, "jax.avi",
                     engines["jax", "f32", False], **kw)
    stats = interpolate_video(clip, "port.avi",
                              engines["port", "f32", False], **kw)
    assert stats == ref_stats
    ref, got = Recorder.frames["jax.avi"], Recorder.frames["port.avi"]
    assert len(got) == len(ref) == stats["frames_written"]
    factor, compat = stats["factor"], kw.get("reference_compat", False)
    sources = _decoded(clip, kw.get("frame_interval", 1), stats["size"])
    assert stats["frames_read"] == len(sources)
    assert stats["frames_written"] == (len(sources) - 1) * (factor + 1) + 1
    slots = _source_slots(len(sources), factor, compat)
    for slot, src in zip(slots, sources):
        np.testing.assert_array_equal(got[slot], src)
        np.testing.assert_array_equal(ref[slot], src)
    inserted = [i for i in range(len(got)) if i not in set(slots)]
    assert len(inserted) == (len(sources) - 1) * factor
    g = np.stack([got[i] for i in inserted])
    r = np.stack([ref[i] for i in inserted])
    assert _levels(g, r) <= LEVELS
    assert np.mean(g == r) >= EXACT_SHARE
    if compat:      # the duplicates are one frame, shifted
        for p in range(len(sources) - 1):
            dup = got[p * (factor + 1):p * (factor + 1) + factor]
            assert all(np.array_equal(d, dup[0]) for d in dup)


class MemorySource:
    """An open capture over frames held in memory (BGR uint8)."""

    def __init__(self, frames, fps):
        self.frames, self.fps, self.i = list(frames), fps, 0
        self.released = False

    def isOpened(self):
        return True

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]

    def get(self, prop):
        h, w = self.frames[0].shape[:2]
        return {video_io.CAP_PROP_FPS: self.fps,
                video_io.CAP_PROP_FRAME_WIDTH: float(w),
                video_io.CAP_PROP_FRAME_HEIGHT: float(h),
                video_io.CAP_PROP_FRAME_COUNT: float(len(self.frames))}[prop]

    def release(self):
        self.released = True


def test_interpolate_video_takes_an_open_source_and_sink(engines, clip,
                                                         monkeypatch):
    """Frames in memory through the open-source seam write what the file
    route writes, and the pipeline releases both."""
    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    kw = dict(target_fps=120.0, scale=1.0, batch_pairs=4)
    eng = engines["port", "f32", False]
    ref = interpolate_video(clip, "file.avi", eng, **kw)
    src = MemorySource(_decoded(clip, 1, (96, 64)), 30.0)
    sink = Recorder("memory")
    assert interpolate_video(src, sink, eng, **kw) == ref
    assert src.released
    assert len(Recorder.frames["memory"]) == ref["frames_written"]
    for a, b in zip(Recorder.frames["memory"], Recorder.frames["file.avi"]):
        np.testing.assert_array_equal(a, b)


def test_interpolate_video_raises_the_readers_error(engines):
    class Broken(MemorySource):
        def read(self):
            if self.i == 2:
                raise OSError("decode failed")
            return super().read()

    frames = [np.zeros((16, 16, 3), np.uint8)] * 5
    with pytest.raises(OSError, match="decode failed"):
        interpolate_video(Broken(frames, 30.0), Recorder("broken"),
                          engines["port", "f32", False], scale=1.0)


def test_interpolate_video_counts_auto_scale_per_run(engines, clip,
                                                    monkeypatch):
    """`auto_scaled_batches` is this run's delta of the engine's lifetime
    counters, as in JAX; the tiny flow net probes every batch."""
    from vfi_tpu.models.flownet import SimpleFlowNet as JSimpleFlowNet

    fnet = JSimpleFlowNet(mid_channels=8, levels=2)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    fparams = jax.tree.map(np.asarray, jax.jit(fnet.init)(
        jax.random.PRNGKey(1), x, x))
    eng = FrameInterpolator(engines["params"], device="cpu",
                            flow_params=fparams,
                            flow_mid_channels=8, flow_levels=2,
                            auto_scale=0.0, **TINY)
    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    for _ in range(2):
        stats = interpolate_video(clip, "as.avi", eng, scale=0.5,
                                  batch_pairs=4)
        assert stats["auto_scaled_batches"] == "2/2"
    assert len(eng.auto_scale_stats["probes"]) == 4


# -- the multi-clip pipeline -----------------------------------------------

@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three clips of two sizes and lengths."""
    d = tmp_path_factory.mktemp("clips")
    spec = ((5, 64, 96), (4, 48, 64), (6, 64, 96))
    paths = []
    for i, (n, h, w) in enumerate(spec):
        p = str(d / f"c{i}.avi")
        _write_clip(p, n, h, w, 15.0, seed=20 + i)
        paths.append(p)
    return paths


@pytest.mark.parametrize("compat", [False, True], ids=["bisect", "compat"])
def test_interpolate_videos_matches_jax(engines, clips, monkeypatch, compat):
    """Three clips at 15 fps (factor 3) through one shared batcher: the
    per-clip stats equal JAX's, and each clip's frames are within a level
    of the port's single-clip run."""
    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    kw = dict(scale=0.5, batch_pairs=4, reference_compat=compat)
    outs = [f"multi{i}.avi" for i in range(len(clips))]
    ref = _jax(jax_interpolate_videos, clips, [f"j{o}" for o in outs],
               engines["jax", "f32", False], max_delay_ms=20.0, **kw)
    got = interpolate_videos(clips, outs, engines["port", "f32", False],
                             max_delay_ms=20.0, **kw)
    strip = [{k: v for k, v in s.items() if k != "batcher"} for s in got]
    assert strip == [{k: v for k, v in s.items() if k != "batcher"}
                     for s in ref]
    total = sum(s["frames_read"] - 1 for s in got)
    launches_per_pair = 1 if compat else 3
    snap = got[0]["batcher"]
    assert snap["requests"] == total * launches_per_pair
    assert all(s["batcher"] is snap for s in got)
    assert set(snap["per_bucket"]) == {"32x48", "24x32"}
    for clip_path, out, st in zip(clips, outs, got):
        assert st["factor"] == 3
        interpolate_video(clip_path, "single.avi",
                          engines["port", "f32", False],
                          **{**kw, "batch_pairs": 8})
        multi, single = Recorder.frames[out], Recorder.frames["single.avi"]
        assert len(multi) == len(single) == st["frames_written"]
        assert _levels(np.stack(multi), np.stack(single)) <= LEVELS


def test_interpolate_videos_raises_after_every_clip_stops(engines, clips,
                                                          monkeypatch):
    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    with pytest.raises(RuntimeError, match="missing.avi") as e:
        interpolate_videos([clips[1], "missing.avi"], ["ok.avi", "x.avi"],
                           engines["port", "f32", False], scale=0.5)
    assert isinstance(e.value.__cause__, IOError)
    assert len(Recorder.frames["ok.avi"]) == 13     # the good clip finished
    with pytest.raises(ValueError):
        interpolate_videos(clips[:2], ["a.avi"], engines["port", "f32",
                                                         False])


def test_shared_engine_borrows_recursive(engines, pair):
    """SharedEngine's recursive is the engine's own, over the batcher."""
    assert SharedEngine.recursive is FrameInterpolator.recursive
    eng = engines["port", "f32", False]
    batcher = MicroBatcher(eng, max_batch=2, max_delay_ms=1.0)
    try:
        got = SharedEngine(batcher).recursive(*pair, 3)
    finally:
        batcher.close()
    ref = eng.recursive(*pair, 3)
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, r.numpy(), atol=1e-6, rtol=0)
