"""Multi-clip up-conversion over one engine, port of
`vfi_tpu/infer/multi.py`.

Each clip runs `interpolate_video` on a thread of its own, but submits
its pairs to one shared `serve.batcher.MicroBatcher` instead of calling
the engine: pairs from every clip coalesce into shared launches (padded to
one shape), so the card stays fed while any one clip's decode trickles.
Clips of different sizes go to the batcher's (H, W) buckets. The clip
threads only submit and wait; the batcher's worker thread runs every
engine launch.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from vfi_tpu_torch.infer.pair import FrameInterpolator
from vfi_tpu_torch.infer.video import interpolate_video
from vfi_tpu_torch.serve.batcher import MicroBatcher


class SharedEngine:
    """One clip's view of a shared MicroBatcher, with the two methods
    `interpolate_video` calls: `midpoints` submits each pair and waits
    for the results (the coalescing across clips happens in the batcher);
    `recursive` is FrameInterpolator's own, which touches only
    `self.midpoints` and `self.reference_compat`."""

    def __init__(self, batcher: MicroBatcher, reference_compat: bool = False,
                 timeout: float = 600.0):
        self._batcher = batcher
        self.reference_compat = reference_compat
        self._timeout = timeout

    def midpoints(self, f0: np.ndarray, f1: np.ndarray) -> np.ndarray:
        futs = [self._batcher.submit(f0[i], f1[i]) for i in range(f0.shape[0])]
        return np.stack([f.result(timeout=self._timeout) for f in futs])

    recursive = FrameInterpolator.recursive


def interpolate_videos(
    inputs: Sequence,
    outputs: Sequence,
    interpolator: FrameInterpolator,
    target_fps: Optional[float] = None,
    max_interpolation_factor: int = 4,
    frame_interval: int = 1,
    codec: str = "mp4v",
    scale: float = 0.5,
    batch_pairs: int = 8,
    reference_compat: bool = False,
    max_delay_ms: float = 50.0,
) -> list[dict]:
    """Upconvert many videos at once over one engine.

    The arguments are `interpolate_video`'s; `batch_pairs` is the shared
    launch size (launches are padded to it) and `max_delay_ms` how long a
    pair waits for batch-mates. Returns one stats dict per clip, each with
    the batcher's snapshot under 'batcher'. A clip's exception is raised
    after every clip has stopped."""
    if len(inputs) != len(outputs):
        raise ValueError(f"{len(inputs)} inputs vs {len(outputs)} outputs")
    batcher = MicroBatcher(interpolator, max_batch=batch_pairs,
                           max_delay_ms=max_delay_ms)
    results: list = [None] * len(inputs)
    errors: list = [None] * len(inputs)

    def worker(i: int):
        try:
            # batch_pairs=1: each clip submits its pairs as they decode;
            # the shared batcher makes the launches
            results[i] = interpolate_video(
                inputs[i], outputs[i],
                SharedEngine(batcher, reference_compat=reference_compat),
                target_fps=target_fps,
                max_interpolation_factor=max_interpolation_factor,
                frame_interval=frame_interval, codec=codec, scale=scale,
                batch_pairs=1, reference_compat=reference_compat)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,), daemon=True,
                                name=f"vfi-clip-{i}")
               for i in range(len(inputs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        batcher.close()
    for i, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"clip {inputs[i]} failed") from e
    stats = batcher.stats.snapshot()
    for r in results:
        r["batcher"] = stats
    return results
