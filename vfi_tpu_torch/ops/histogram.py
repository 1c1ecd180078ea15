"""Colour histograms (NHWC), the port of `vfi_tpu/ops/histogram.py`, each
one `scatter_add_` over a flat (image, channel, bin) index.

`color_histogram` is the reference loss's exact 256-bin histogram: floor,
clamp, count, over H * W. It carries no gradient (the counts are
constants). `soft_color_histogram` splits each pixel's unit mass linearly
between its two neighbouring bins; its gradient goes through the
fractional weights."""

from __future__ import annotations

import torch


def _offsets(b: int, c: int, num_bins: int, device) -> torch.Tensor:
    return (torch.arange(b * c, device=device) * num_bins)[:, None]


def color_histogram(x: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """(B, H, W, C), nominally in [0, 1] (values outside clamp into the end
    bins) -> (B, C, num_bins) histograms normalized by H * W."""
    b, h, w, c = x.shape
    inds = torch.floor(x.detach() * (num_bins - 1)).clamp(0, num_bins - 1)
    inds = inds.long().permute(0, 3, 1, 2).reshape(b * c, h * w)
    flat = (inds + _offsets(b, c, num_bins, x.device)).reshape(-1)
    hist = torch.zeros(b * c * num_bins, dtype=x.dtype, device=x.device)
    hist.scatter_add_(0, flat, torch.ones_like(flat, dtype=x.dtype))
    return hist.reshape(b, c, num_bins) / (h * w)


def soft_color_histogram(x: torch.Tensor, num_bins: int = 256
                         ) -> torch.Tensor:
    """Differentiable (linear-binning) histogram: (B, C, num_bins)."""
    b, h, w, c = x.shape
    # min(max(.)) rather than clamp: at a value on a bound the gradient
    # splits between the tied arguments, as `jnp.clip`'s does.
    v = torch.minimum(torch.maximum(x * (num_bins - 1), x.new_zeros(())),
                      x.new_full((), num_bins - 1.0))
    v = v.permute(0, 3, 1, 2).reshape(b * c, h * w)
    i0f = torch.floor(v.detach())
    frac = v - i0f
    i0 = i0f.long()
    i1 = (i0 + 1).clamp_max(num_bins - 1)
    offs = _offsets(b, c, num_bins, x.device)
    hist = torch.zeros(b * c * num_bins, dtype=x.dtype, device=x.device)
    hist = hist.scatter_add(0, (i0 + offs).reshape(-1),
                            (1.0 - frac).reshape(-1))
    hist = hist.scatter_add(0, (i1 + offs).reshape(-1), frac.reshape(-1))
    return hist.reshape(b, c, num_bins) / (h * w)
