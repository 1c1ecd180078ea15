"""Bounded modulated deformable conv (DCNv2), plain PyTorch — the port of
`vfi_tpu/ops/deform_conv_shifts.py` and the plain version of the CUDA
kernel `csrc/dcn_bounded.cu` (`ops/cuda/sampling.deform_conv2d_bounded`).

Per output pixel p and 3x3 tap t: clamp the tap's learned offset (dy, dx)
to [-R, R] in float32, bilinear-sample x at p + tap + offset (corners
outside the image read 0), scale by the tap's mask, and contract Cin ->
Cout with weight[tap]; sum the taps and add the bias. Offsets use
torchvision's layout: channels (2t, 2t+1) = (dy, dx) of tap t = 3i + j.

Numerics: the sample weights and blends are float32; the blended sample
(the modulated sample matrix, one Cin row per tap) is held in the working
dtype — as the TPU kernels hold their sample buffer — and the contraction
accumulates in float32 and rounds once. In float32 this is the JAX op's
function to float32 rounding. The JAX shifts op in bf16 also accumulates
the taps in bf16; this version does not.
"""

from __future__ import annotations

from typing import Optional

import torch


def deform_conv2d_shifts(x: torch.Tensor, offset: torch.Tensor,
                         mask: Optional[torch.Tensor], weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         max_offset: int = 3,
                         padding: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin); offset (B, H, W, 2*kh*kw); mask (B, H, W, kh*kw)
    or None; weight OIHW (Cout, Cin, kh, kw); bias (Cout,) or None.
    Stride 1, one offset group. Returns (B, H, W, Cout) in x's dtype."""
    b, h, w, cin = x.shape
    cout, cin_w, kh, kw = weight.shape
    if cin_w != cin:
        raise ValueError("deform_conv2d_shifts supports groups == 1 only")
    n_taps = kh * kw
    if offset.shape[-1] != 2 * n_taps:
        raise ValueError("deform_conv2d_shifts supports one offset group only")
    r = float(int(max_offset))
    dtype = x.dtype
    dev = x.device

    flat = x.float().reshape(b, h * w, cin)
    off = offset.float().reshape(b, h, w, n_taps, 2).clamp(-r, r)
    msk = None if mask is None else mask.float().reshape(b, h, w, n_taps)
    w_taps = weight.to(dtype).float().permute(2, 3, 1, 0).reshape(
        n_taps, cin, cout)
    ygrid = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xgrid = torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    acc = torch.zeros(b * h * w, cout, dtype=torch.float32, device=dev)
    for t in range(n_taps):
        i, j = divmod(t, kw)
        ty = ygrid + (i - padding) + off[..., t, 0]
        tx = xgrid + (j - padding) + off[..., t, 1]
        y0f = torch.floor(ty)
        x0f = torch.floor(tx)
        fy = ty - y0f
        fx = tx - x0f
        y0 = y0f.long()
        x0 = x0f.long()
        samp = None
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                yy = y0 + dy
                xx = x0 + dx
                inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                wgt = wy * wx
                if msk is not None:
                    wgt = wgt * msk[..., t]
                wgt = wgt * inb
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
                v = torch.gather(flat, 1, idx.reshape(b, -1, 1)
                                 .expand(-1, -1, cin)).reshape(b, h, w, cin)
                term = wgt[..., None] * v
                samp = term if samp is None else samp + term
        samp = samp.to(dtype).float()
        acc = acc + samp.reshape(-1, cin) @ w_taps[t]
    if bias is not None:
        acc = acc + bias.to(dtype).float()
    return acc.reshape(b, h, w, cout).to(dtype)
