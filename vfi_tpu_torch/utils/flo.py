"""Middlebury .flo optical-flow files, port of `vfi_tpu/utils/flo.py`:
a 4-byte magic float 202021.25, int32 width and height, then row-major
interleaved (u, v) float32 pairs. Values above 1e9 mark unknown flow."""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 202021.25
UNKNOWN_THRESHOLD = 1e9


def read_flo(path: str) -> np.ndarray:
    """A .flo file -> (H, W, 2) float32 flow (u = dx, v = dy); unknown
    pixels keep their sentinel values."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - _MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """An (H, W, 2) flow -> a .flo file of its float32 values; the bytes
    of `vfi_tpu.utils.flo.write_flo`'s file. ValueError unless the flow
    is (H, W, 2)."""
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<f", _MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(np.ascontiguousarray(flow, np.float32).tobytes())


def flow_valid_mask(flow: np.ndarray) -> np.ndarray:
    """(H, W) bool mask of the pixels with known flow."""
    return np.all(np.abs(flow) < UNKNOWN_THRESHOLD, axis=-1)


def endpoint_error(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean endpoint error over the valid GT pixels."""
    mask = flow_valid_mask(gt)
    diff = pred - gt
    epe = np.sqrt(np.sum(diff * diff, axis=-1))
    return float(epe[mask].mean())
