"""Video frame-rate up-conversion, port of `vfi_tpu/infer/video.py`.

`interpolate_video` decodes ahead on a reader thread into a bounded
queue, batches `batch_pairs` consecutive pairs into one engine call
(`midpoints` for one inserted frame, `recursive` for more), copies each
batch's frames to the host once, and writes every source frame followed by
the frames inserted after it, in RGB-correct colour. `reference_compat`
keeps the reference CLI's three quirks for output parity: the stats of a
BGR frame, each pair's duplicated midpoints (shifted by the inverse
ImageNet transform) written before its first source frame.

The input and output are paths (read and written with cv2,
`infer.video_io`) or an already-open source and sink with the capture's
and writer's methods, e.g. frames held in memory. Only the calling thread
runs the engine: the reader thread decodes and converts.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from vfi_tpu_torch.infer.pair import pick_interpolation_factor
from vfi_tpu_torch.infer.video_io import (CAP_PROP_FPS, CAP_PROP_FRAME_COUNT,
                                          CAP_PROP_FRAME_HEIGHT,
                                          CAP_PROP_FRAME_WIDTH, open_capture,
                                          open_writer, to_float, to_u8)
from vfi_tpu_torch.serve.batcher import to_host

logger = logging.getLogger("vfi_tpu_torch.infer")


def _is_path(x) -> bool:
    return isinstance(x, (str, os.PathLike))


def _frames_on_host(outs: list) -> np.ndarray:
    """`recursive`'s list of (B, H, W, 3) results -> one (B, factor, H, W,
    3) host array, copied from the device in one transfer."""
    if isinstance(outs[0], torch.Tensor):
        return to_host(torch.stack(outs, dim=1))
    return np.stack([np.asarray(o) for o in outs], axis=1)


def interpolate_video(
    input_video,
    output_video,
    interpolator,
    target_fps: Optional[float] = None,
    max_interpolation_factor: int = 4,
    frame_interval: int = 1,
    codec: str = "mp4v",
    scale: float = 0.5,
    batch_pairs: int = 8,
    reference_compat: bool = False,
) -> dict:
    """Upconvert a video's frame rate by inserting interpolated frames.

    `interpolator` has `midpoints` and `recursive` over float32 [0, 1]
    frames (`FrameInterpolator`, or the multi-clip `SharedEngine`). The
    factor is `pick_interpolation_factor(src fps, target_fps, max)`; every
    `frame_interval`-th source frame is used, resized by `scale`. Returns
    the stats: frames read and written, factor, output fps, (w, h), and
    `auto_scaled_batches` ("scaled/probes" of this run) where the engine
    probed."""
    start = getattr(interpolator, "auto_scale_stats",
                    {"probes": [], "scaled": 0})
    as_probes0, as_scaled0 = len(start["probes"]), start["scaled"]
    swap_rgb = not reference_compat
    cap = open_capture(input_video) if _is_path(input_video) else input_video
    stop = threading.Event()
    thread = None
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {input_video}")
        src_fps = cap.get(CAP_PROP_FPS) or 30.0
        w = int(cap.get(CAP_PROP_FRAME_WIDTH) * scale)
        h = int(cap.get(CAP_PROP_FRAME_HEIGHT) * scale)
        n_frames = int(cap.get(CAP_PROP_FRAME_COUNT))
        factor, out_fps = pick_interpolation_factor(
            src_fps, target_fps, max_interpolation_factor)
        logger.info("%s: %dx%d @ %.2f fps, %d frames -> factor %d, %.2f fps",
                    input_video, w, h, src_fps, n_frames, factor, out_fps)

        if _is_path(output_video):
            writer = open_writer(output_video, codec, out_fps, (w, h))
        else:
            writer = output_video
            if not writer.isOpened():
                raise IOError(f"cannot open writer: {output_video}")

        # Decode, resize and convert ahead of the engine; an exception on
        # the reader thread goes through the queue to the caller.
        frames_q: queue.Queue = queue.Queue(maxsize=4 * max(batch_pairs, 1))

        def put(item) -> None:
            while not stop.is_set():
                try:
                    frames_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def reader():
            try:
                idx = 0
                while not stop.is_set():
                    ok, frame = cap.read()
                    if not ok:
                        break
                    if idx % frame_interval == 0:
                        put(to_float(frame, (w, h), swap_rgb))
                    idx += 1
                put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                put(e)

        thread = threading.Thread(target=reader, daemon=True,
                                  name="vfi-video-reader")
        thread.start()

        read, written = 0, 0
        prev: Optional[np.ndarray] = None
        pend_f0: list = []
        pend_f1: list = []

        def flush():
            nonlocal written
            if not pend_f0:
                return
            f0 = np.stack(pend_f0)
            f1 = np.stack(pend_f1)
            if factor == 1 or reference_compat:
                mids = to_host(interpolator.midpoints(f0, f1))
                per_pair = [[mids[i]] * factor for i in range(len(pend_f0))]
            else:
                outs = _frames_on_host(interpolator.recursive(f0, f1, factor))
                per_pair = [list(outs[i]) for i in range(len(pend_f0))]
            for i in range(len(pend_f0)):
                if reference_compat:
                    # the reference's order: the inserted frames (shifted
                    # by its inverse-ImageNet quirk), then the pair's first
                    # source frame, whose normalize / inverse round trip
                    # is the identity, so it is written unshifted
                    for m in per_pair[i]:
                        writer.write(to_u8(m, swap_rgb, True))
                    writer.write(to_u8(pend_f0[i], swap_rgb, False))
                else:
                    writer.write(to_u8(pend_f0[i], swap_rgb, False))
                    for m in per_pair[i]:
                        writer.write(to_u8(m, swap_rgb, False))
                written += factor + 1
            pend_f0.clear()
            pend_f1.clear()

        # a bar over the source frames; none where tqdm is not installed
        try:
            from tqdm import tqdm
            bar = tqdm(total=n_frames or None, desc="interpolating",
                       unit="frame")
        except ImportError:
            bar = None
        while True:
            item = frames_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            read += 1
            if bar is not None:
                bar.update(frame_interval)
            if prev is not None:
                pend_f0.append(prev)
                pend_f1.append(item)
                if len(pend_f0) >= batch_pairs:
                    flush()
            prev = item
        if bar is not None:
            bar.close()
        flush()
        if prev is not None:
            # the trailing source frame, which the reference writes too
            writer.write(to_u8(prev, swap_rgb, False))
            written += 1
        writer.release()
        stats = {"frames_read": read, "frames_written": written,
                 "factor": factor, "output_fps": out_fps, "size": (w, h)}
        # this run's share of the engine's lifetime auto_scale counters
        end = getattr(interpolator, "auto_scale_stats",
                      {"probes": [], "scaled": 0})
        d_probes = len(end["probes"]) - as_probes0
        if d_probes:
            stats["auto_scaled_batches"] = (
                f'{end["scaled"] - as_scaled0}/{d_probes}')
        return stats
    finally:
        stop.set()
        if thread is not None:
            thread.join()
        cap.release()
