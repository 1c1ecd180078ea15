"""Video file I/O and frame conversion of the video pipelines.

Files are read and written with OpenCV (`cv2.VideoCapture`,
`cv2.VideoWriter`), imported inside the functions that need it and
nowhere else: importing the port never loads cv2, and the pipelines run
without it on frames held in memory (a source with the capture's `read` /
`get` / `isOpened` / `release`, a sink with the writer's `write` /
`isOpened` / `release`). Without cv2 the file functions raise ImportError.

`to_float` and `to_u8` are copies of `vfi_tpu/infer/video.py`'s frame
conversions: BGR uint8 -> RGB float32 [0, 1] (resized to the output
size), and back by truncation, `(x * 255).astype(uint8)` (the serve
route's `io_uint8` rounds instead).
"""

from __future__ import annotations

import numpy as np

from vfi_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD

# cv2's capture property ids (`cv2.CAP_PROP_*`), which a source's `get`
# takes.
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5
CAP_PROP_FRAME_COUNT = 7


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "video files need OpenCV (the cv2 module), which the `video` "
            "and `videos` commands read and write them with; it is not "
            "installed") from e
    return cv2


def open_capture(path: str):
    """A `cv2.VideoCapture` of `path`; IOError when it does not open."""
    cap = _cv2().VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    return cap


def open_writer(path: str, codec: str, fps: float, size_wh):
    """A `cv2.VideoWriter` at `path` (FourCC `codec`, `fps`, (W, H));
    IOError when it does not open."""
    cv2 = _cv2()
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps,
                             size_wh)
    if not writer.isOpened():
        raise IOError(f"cannot open writer: {path}")
    return writer


def to_float(frame_bgr: np.ndarray, size_wh, swap_rgb: bool) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (h, w, 3) float32 [0, 1] at `size_wh` = (w,
    h) (`cv2.resize` where the size differs), RGB where `swap_rgb`."""
    if (frame_bgr.shape[1], frame_bgr.shape[0]) != tuple(size_wh):
        frame_bgr = _cv2().resize(frame_bgr, tuple(size_wh))
    if swap_rgb:
        frame_bgr = frame_bgr[..., ::-1]
    return np.ascontiguousarray(frame_bgr, np.float32) / 255.0


def to_u8(frame01: np.ndarray, swap_rgb: bool, compat: bool) -> np.ndarray:
    """float32 [0, 1] RGB -> uint8 (BGR where `swap_rgb`) by truncation.
    `compat`: first the reference CLI's inverse-ImageNet shift of an
    output already in [0, 1] (a fixed contrast and brightness change)."""
    x = np.asarray(frame01, np.float32)
    if compat:
        x = x * IMAGENET_STD + IMAGENET_MEAN
    x = np.clip(x, 0.0, 1.0)
    u8 = (x * 255.0).astype(np.uint8)
    return u8[..., ::-1] if swap_rgb else u8
