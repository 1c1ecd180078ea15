"""Sobel gradients (depthwise, NHWC), the port of `vfi_tpu/ops/sobel.py`:
one grouped 3x3 correlation a direction, zero padding. `F.conv2d`
correlates, as `lax.conv` does, so the kernels are not flipped."""

from __future__ import annotations

import torch
import torch.nn.functional as F

SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def sobel_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) -> per-channel (Gx, Gy), each (B, H, W, C)."""
    c = x.shape[-1]
    k = torch.tensor((SOBEL_X, SOBEL_Y), dtype=x.dtype, device=x.device)
    k = k[:, None].repeat(c, 1, 1, 1)       # (2C, 1, 3, 3): x, y a channel
    g = F.conv2d(x.permute(0, 3, 1, 2), k, padding=1, groups=c)
    g = g.permute(0, 2, 3, 1)
    return g[..., 0::2], g[..., 1::2]
