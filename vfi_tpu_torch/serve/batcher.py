"""Shape-bucketed micro-batching for online interpolation serving, port
of `vfi_tpu/serve/batcher.py`.

Requests are bucketed by frame shape (H, W), and concurrent requests of
one bucket coalesce into one engine launch: the per-launch costs (the
upload, the launches of ~100 kernels and plain ops, the download) are paid
once a batch. A request still launches after `max_delay_ms` when no
batch-mate comes, so the latency price of batching is bounded and
explicit. With `pad_to_max` every launch of a bucket has one batch size,
so the card sees one set of shapes per bucket (one cuDNN plan, one
allocator pattern) after warm-up. Sequence requests are launches of their
own (`engine.midpoints_sequence`).

The batcher fronts any engine with a `midpoints(f0, f1) -> (B, H, W, 3)`
method (`vfi_tpu_torch.infer.pair.FrameInterpolator`) that returns a
tensor (copied to the host once a launch) or a numpy array. One worker
thread runs every launch, so the engine is called from one thread at a
time.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass
class _Request:
    f0: np.ndarray
    f1: np.ndarray
    future: Future
    t_submit: float


@dataclass
class _SeqRequest:
    frames: np.ndarray          # (N+1, H, W, 3)
    future: Future
    t_submit: float


@dataclass
class BatcherStats:
    """Counters the worker updates under the batcher lock."""

    requests: int = 0
    batches: int = 0
    padded_items: int = 0
    errors: int = 0
    per_bucket: Dict[str, int] = field(default_factory=dict)
    batch_sizes: deque = field(default_factory=lambda: deque(maxlen=1024))
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=1024))

    def snapshot(self) -> dict:
        sizes = list(self.batch_sizes)
        lats = sorted(self.latencies_ms)

        def pct(p):
            return lats[min(len(lats) - 1, int(p * len(lats)))] if lats else None

        return {
            "requests": self.requests,
            "batches": self.batches,
            "padded_items": self.padded_items,
            "errors": self.errors,
            "per_bucket": dict(self.per_bucket),
            "mean_batch_size": (sum(sizes) / len(sizes)) if sizes else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p99": pct(0.99),
        }


def to_host(out) -> np.ndarray:
    """An engine's result as one host array: a tensor (on the card or the
    CPU) is copied once; an array passes through."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


class MicroBatcher:
    """Coalesces concurrent midpoint requests into fixed-shape device batches.

    Args:
      engine: object with `midpoints(f0, f1)` over (B, H, W, 3) arrays in
        its `io_dtype` (float32 [0, 1] by default, uint8 [0, 255] with
        FrameInterpolator's io_uint8).
      max_batch: device batch size per launch; also the pad target.
      max_delay_ms: longest a request may wait for batch-mates before its
        bucket launches anyway.
      pad_to_max: pad every launch to the bucket's launch size by repeating
        the last pair (results sliced off). Guarantees one executable per
        bucket; turn off only for offline/throughput-insensitive use.
      max_px_per_launch: memory guard — cap each bucket's launch size so
        batch * H * W never exceeds this many pixels (large-resolution
        buckets launch smaller batches; floor 1). Forward-activation memory
        is ~linear in batch pixels, so one pixel budget covers every
        bucket. None = no cap (max_batch everywhere). The engine's own
        guard (`max_px_per_launch` of FrameInterpolator) may split a
        launch further.
    """

    def __init__(self, engine, max_batch: int = 8, max_delay_ms: float = 5.0,
                 pad_to_max: bool = True,
                 max_px_per_launch: int | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_px_per_launch is not None and max_px_per_launch < 1:
            raise ValueError("max_px_per_launch must be >= 1 or None")
        self.engine = engine
        # engines advertising io_dtype=uint8 (FrameInterpolator io_uint8)
        # take/return u8 [0,255]; the batcher converts submissions to match
        self.io_dtype = np.dtype(getattr(engine, "io_dtype", np.float32))
        self.max_px = (None if max_px_per_launch is None
                       else int(max_px_per_launch))
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.pad_to_max = bool(pad_to_max)
        self.stats = BatcherStats()
        self._buckets: Dict[Tuple[int, int], deque] = {}
        self._seqs: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="vfi-microbatcher")
        self._worker.start()

    # -- client side ------------------------------------------------------

    def _coerce(self, f: np.ndarray) -> np.ndarray:
        """Convert a [0,1] float or [0,255] u8 frame to the engine dtype."""
        f = np.asarray(f)
        if f.dtype == self.io_dtype:
            return f
        if self.io_dtype == np.uint8:  # float [0,1] -> u8
            return np.clip(np.asarray(f, np.float32) * 255.0 + 0.5,
                           0, 255).astype(np.uint8)
        if f.dtype == np.uint8:        # u8 -> float [0,1]
            return f.astype(np.float32) / 255.0
        return np.asarray(f, np.float32)

    def submit(self, f0: np.ndarray, f1: np.ndarray) -> Future:
        """Enqueue one pair; resolves to the (H, W, 3) midpoint in the
        engine's io dtype (float32 [0,1] or uint8 [0,255])."""
        f0 = self._coerce(f0)
        f1 = self._coerce(f1)
        if f0.ndim != 3 or f0.shape[-1] != 3 or f0.shape != f1.shape:
            raise ValueError(
                f"expected two (H, W, 3) frames of one shape, got "
                f"{f0.shape} vs {f1.shape}")
        req = _Request(f0, f1, Future(), time.monotonic())
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._buckets.setdefault(f0.shape[:2], deque()).append(req)
            self.stats.requests += 1
            self._cv.notify()
        return req.future

    def interpolate(self, f0: np.ndarray, f1: np.ndarray,
                    timeout: float | None = None) -> np.ndarray:
        """Blocking convenience wrapper around `submit`."""
        return self.submit(f0, f1).result(timeout=timeout)

    def submit_sequence(self, frames: np.ndarray) -> Future:
        """Enqueue an (N+1, H, W, 3) consecutive-frame sequence; resolves
        to the (N, H, W, 3) midpoints. A sequence is its own device launch
        (engine.midpoints_sequence ships each frame to the device once; no
        coalescing or padding)."""
        frames = np.stack([self._coerce(f) for f in np.asarray(frames)])
        if frames.ndim != 4 or frames.shape[0] < 2 or frames.shape[-1] != 3:
            raise ValueError(f"expected (N+1>=2, H, W, 3) frames, got "
                             f"{frames.shape}")
        req = _SeqRequest(frames, Future(), time.monotonic())
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._seqs.append(req)
            self.stats.requests += frames.shape[0] - 1
            self._cv.notify()
        return req.future

    def interpolate_sequence(self, frames: np.ndarray,
                             timeout: float | None = None) -> np.ndarray:
        """Blocking convenience wrapper around `submit_sequence`."""
        return self.submit_sequence(frames).result(timeout=timeout)

    def close(self):
        """Stop accepting work, drain queued requests, join the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join()

    # -- worker side ------------------------------------------------------

    def launch_size(self, shape: Tuple[int, int]) -> int:
        """A bucket's device batch: max_batch, shrunk to the pixel budget.

        With pad_to_max this is the one batch size the bucket launches, so
        it must be a pure function of (H, W) and the config."""
        if self.max_px is None:
            return self.max_batch
        return max(1, min(self.max_batch, self.max_px // (shape[0] * shape[1])))

    def _ready_bucket(self, now: float):
        """The ready bucket with the earliest head deadline, else
        (None, soonest deadline).

        Among ready buckets, earliest-deadline-first — returning the first
        ready bucket in dict order would let a saturated majority-shape
        bucket (always >= max_batch) starve a minority-resolution request
        past its max_delay_ms bound indefinitely."""
        soonest = None
        best = None
        for shape, q in self._buckets.items():
            if not q:
                continue
            deadline = q[0].t_submit + self.max_delay
            if (len(q) >= self.launch_size(shape) or now >= deadline
                    or self._closed):
                if best is None or deadline < best[1]:
                    best = (shape, deadline)
            else:
                soonest = deadline if soonest is None else min(soonest, deadline)
        if best is not None:
            return best[0], None
        return None, soonest

    def _run(self):
        while True:
            seq = None
            with self._cv:
                while True:
                    if self._seqs:  # sequences are ready immediately
                        seq = self._seqs.popleft()
                        break
                    shape, soonest = self._ready_bucket(time.monotonic())
                    if shape is not None:
                        q = self._buckets[shape]
                        cap = self.launch_size(shape)
                        batch = [q.popleft()
                                 for _ in range(min(len(q), cap))]
                        break
                    if self._closed:  # closed + nothing ready = drained
                        return
                    self._cv.wait(timeout=(None if soonest is None else
                                           max(soonest - time.monotonic(), 0)))
            if seq is not None:
                self._launch_seq(seq)
            else:
                self._launch(shape, batch)

    def _launch(self, shape, batch):
        n = len(batch)
        f0 = np.stack([r.f0 for r in batch])
        f1 = np.stack([r.f1 for r in batch])
        cap = self.launch_size(shape)
        if self.pad_to_max and n < cap:
            pad = cap - n
            f0 = np.concatenate([f0, np.repeat(f0[-1:], pad, axis=0)])
            f1 = np.concatenate([f1, np.repeat(f1[-1:], pad, axis=0)])
        try:
            out = to_host(self.engine.midpoints(f0, f1))
        except Exception as e:  # noqa: BLE001 - forwarded to every waiter
            with self._cv:
                self.stats.errors += n
            for r in batch:
                r.future.set_exception(e)
            return
        now = time.monotonic()
        key = f"{shape[0]}x{shape[1]}"
        with self._cv:
            self.stats.batches += 1
            self.stats.batch_sizes.append(n)
            self.stats.padded_items += max(0, f0.shape[0] - n)
            self.stats.per_bucket[key] = self.stats.per_bucket.get(key, 0) + n
            for r in batch:
                self.stats.latencies_ms.append((now - r.t_submit) * 1e3)
        for i, r in enumerate(batch):
            r.future.set_result(out[i])

    def _launch_seq(self, req: _SeqRequest):
        n = req.frames.shape[0] - 1
        try:
            out = to_host(self.engine.midpoints_sequence(req.frames))
        except Exception as e:  # noqa: BLE001 - forwarded to the waiter
            with self._cv:
                self.stats.errors += n
            req.future.set_exception(e)
            return
        now = time.monotonic()
        key = f"{req.frames.shape[1]}x{req.frames.shape[2]}seq"
        with self._cv:
            self.stats.batches += 1
            self.stats.batch_sizes.append(n)
            self.stats.per_bucket[key] = self.stats.per_bucket.get(key, 0) + n
            self.stats.latencies_ms.append((now - req.t_submit) * 1e3)
        req.future.set_result(out)

    def warmup(self, height: int, width: int):
        """Run a bucket's launch ahead of traffic (one full-size launch of
        zeros; with pad_to_max this is the steady-state shape): the
        kernels' build, cuDNN's plans and the allocator's pools are paid
        here, not by the first request."""
        b = self.launch_size((height, width))
        z = np.zeros((b, height, width, 3), self.io_dtype)
        to_host(self.engine.midpoints(z, z))

    def warmup_sequence(self, n_frames: int, height: int, width: int):
        """Run the sequence route for an (n_frames, H, W) request ahead of
        traffic: the exact engine.midpoints_sequence call a real request
        takes, including the guard's chunking, so every chunk shape it
        produces is warm too."""
        if n_frames < 2:
            raise ValueError("sequence warmup needs n_frames >= 2")
        z = np.zeros((n_frames, height, width, 3), self.io_dtype)
        to_host(self.engine.midpoints_sequence(z))
