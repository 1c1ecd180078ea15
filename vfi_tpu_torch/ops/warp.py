"""Backward warping (NHWC), the port of `vfi_tpu/ops/warp.py`.

`F.grid_sample(align_corners=True, padding_mode="zeros")` semantics sampled
directly at pixel coordinates: output(y, x) = image(y + dy, x + dx), flow
channels (dx, dy). Coordinates are float32 (bf16 cannot hold integer
positions above 256); the fractional weights are rounded to the image
dtype and the blend runs in it, as the JAX op does, so a bf16 image warps
with the same roundings on both sides.

This is the exact, unbounded warp: the flow prior, the cascade pre-warp
and SimpleFlowNet use it. The bounded warp of the model's RGB frame is the
CUDA kernel in `ops/cuda/sampling.py`, whose plain version calls this on
the clipped flow. `mode="nearest"` is the loss-side warp of the temporal
term; `grid_sample` takes a normalized grid as `F.grid_sample` does.
"""

from __future__ import annotations

import torch


def _gather_hw(flat: torch.Tensor, w: int, yi: torch.Tensor,
               xi: torch.Tensor) -> torch.Tensor:
    """flat (B, H*W, C); yi, xi (B, Ho, Wo) in-bounds -> (B, Ho, Wo, C)."""
    b, _, c = flat.shape
    idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(flat, 1, idx).reshape(yi.shape + (c,))


def bilinear_sample(image: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample (B, H, W, C) images at absolute pixel coordinates
    ys, xs of shape (B, Ho, Wo); corners outside the image read 0."""
    _, h, w, _ = image.shape
    dtype = image.dtype
    xs = xs.float()
    ys = ys.float()
    x0f = torch.floor(xs)
    y0f = torch.floor(ys)
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = x0 + 1
    y1 = y0 + 1

    wx1 = (xs - x0f).to(dtype)
    wy1 = (ys - y0f).to(dtype)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def inb(yi, xi):
        return ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(dtype)[..., None]

    x0c = x0.clamp(0, w - 1)
    x1c = x1.clamp(0, w - 1)
    y0c = y0.clamp(0, h - 1)
    y1c = y1.clamp(0, h - 1)
    flat = image.reshape(image.shape[0], h * w, image.shape[3])

    v00 = _gather_hw(flat, w, y0c, x0c) * inb(y0, x0)
    v01 = _gather_hw(flat, w, y0c, x1c) * inb(y0, x1)
    v10 = _gather_hw(flat, w, y1c, x0c) * inb(y1, x0)
    v11 = _gather_hw(flat, w, y1c, x1c) * inb(y1, x1)

    w00 = (wy0 * wx0)[..., None]
    w01 = (wy0 * wx1)[..., None]
    w10 = (wy1 * wx0)[..., None]
    w11 = (wy1 * wx1)[..., None]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11


def nearest_sample(image: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample of (B, H, W, C) images at absolute pixel
    coordinates ys, xs (B, Ho, Wo), zeros outside. Rounds half to even
    (`torch.round`, as `jnp.round` and torch's grid_sampler)."""
    _, h, w, _ = image.shape
    xi = torch.round(xs.float()).long()
    yi = torch.round(ys.float()).long()
    valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(
        image.dtype)[..., None]
    flat = image.reshape(image.shape[0], h * w, image.shape[3])
    v = _gather_hw(flat, w, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
    return v * valid


_SAMPLERS = {"bilinear": bilinear_sample, "nearest": nearest_sample}


def _sampler(mode: str):
    if mode not in _SAMPLERS:
        raise ValueError(f"mode must be one of {tuple(_SAMPLERS)}, got "
                         f"{mode!r}")
    return _SAMPLERS[mode]


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear") -> torch.Tensor:
    """`F.grid_sample(align_corners=True, padding_mode="zeros")` on NHWC:
    `grid` (B, Ho, Wo, 2) normalized to [-1, 1], last dim (x, y)."""
    _, h, w, _ = image.shape
    xs = (grid[..., 0].float() + 1.0) * 0.5 * (w - 1)
    ys = (grid[..., 1].float() + 1.0) * 0.5 * (h - 1)
    return _sampler(mode)(image, ys, xs)


def warp(image: torch.Tensor, flow: torch.Tensor,
         mode: str = "bilinear") -> torch.Tensor:
    """Backward-warp (B, H, W, C) `image` by (B, H, W, 2) `flow` in pixels,
    channels (dx, dy); bilinear (the model's warp) or nearest (the
    temporal loss's), zeros padding."""
    sample = _sampler(mode)
    _, h, w, _ = image.shape
    dev = image.device
    ygrid = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xgrid = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    xs = xgrid + flow[..., 0].float()
    ys = ygrid + flow[..., 1].float()
    return sample(image, ys, xs)
