"""Bilinear resize with `F.interpolate(mode="bilinear",
align_corners=False)` semantics and no antialiasing — the port of
`vfi_tpu/ops/resize.py`.

Separable: two small interpolation-matrix products (out x in), the same
formulation as the JAX op, so a bf16 image resizes with the matrix rounded
to bf16 on both sides.

`resize_u8` resizes a uint8 image as Pillow's `BILINEAR` does (the JAX
CLIs' `--size`): antialiased when it shrinks, rounded to uint8.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _interp_matrix(out_size: int, in_size: int, align_corners: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(out_size, in_size) interpolation matrix in `dtype`; cached, since
    it depends only on its arguments (callers must not modify it)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            src = torch.zeros(out_size, dtype=torch.float32, device=device)
        else:
            src = i * ((in_size - 1) / (out_size - 1))
    else:
        # half-pixel centres; torch clamps negative sources to 0
        src = ((i + 0.5) * (in_size / out_size) - 0.5).clamp_min(0.0)
    i0 = torch.floor(src).long().clamp(0, in_size - 1)
    i1 = (i0 + 1).clamp(0, in_size - 1)
    w1 = src - i0.float()
    w0 = 1.0 - w1
    m = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
    rows = torch.arange(out_size, device=device)
    m.index_put_((rows, i0), w0, accumulate=True)
    m.index_put_((rows, i1), w1, accumulate=True)
    return m.to(dtype)


def resize_bilinear(image: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize NHWC `image` to `size` = (H', W')."""
    _, h, w, _ = image.shape
    oh, ow = size
    mh = _interp_matrix(oh, h, align_corners, image.device, image.dtype)
    mw = _interp_matrix(ow, w, align_corners, image.device, image.dtype)
    out = torch.einsum("oh,bhwc->bowc", mh, image)
    return torch.einsum("pw,bowc->bopc", mw, out)


def resize_u8(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8: bilinear, antialiased when it
    shrinks (as Pillow's BILINEAR resize), rounded to the nearest level."""
    t = torch.from_numpy(np.array(frame)).permute(2, 0, 1)[None].float()
    t = F.interpolate(t, size=(h, w), mode="bilinear", antialias=True,
                      align_corners=False)
    return t[0].permute(1, 2, 0).round().clamp(0, 255).to(
        torch.uint8).numpy()
