"""Modulated deformable convolution (DCNv2), exact and unbounded, plain
PyTorch, NHWC: the port of `vfi_tpu/ops/deform_conv.py` (whose seed is
`deform_conv2d_torch` in `tools/torch_reference.py`, copied here, not
imported).

Per output pixel p and k x k tap t of each offset group: bilinear-sample
the group's input channels at p * stride - padding + t * dilation +
offset (corners outside the image read 0, carried by the corner weights),
scale by the tap's mask, and contract Cin -> Cout with weight[tap] (per
weight group); sum the taps and add the bias. Layouts follow torchvision:
offset (B, Ho, Wo, 2 * og * kh * kw), channel ((g * kh + i) * kw + j) * 2
= dy and + 1 = dx; mask (B, Ho, Wo, og * kh * kw); the offset groups og
are inferred from the offset's width.

Numerics: coordinates, sample weights and blends are float32 (bf16
cannot hold pixel coordinates above 256); the blended sample of a tap is
held in the working dtype (x's) and the contraction accumulates every tap
in float32 and rounds once. In float32 this is the JAX op's function to
float32 rounding; the JAX op in bf16 also rounds each tap's product and
the running sum to bf16, and this version does not.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  mask: Optional[torch.Tensor], weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  stride: IntPair = 1, padding: IntPair = 1,
                  dilation: IntPair = 1) -> torch.Tensor:
    """x (B, H, W, Cin); offset (B, Ho, Wo, 2 * og * kh * kw); mask (B, Ho,
    Wo, og * kh * kw), already sigmoided, or None (DCNv1: mask 1); weight
    OIHW (Cout, Cin // groups, kh, kw), the weight groups inferred; bias
    (Cout,) or None. Returns (B, Ho, Wo, Cout) in x's dtype, Ho = (H + 2 *
    ph - dh * (kh - 1) - 1) // sh + 1 (Wo alike)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    _, h, w, cin = x.shape
    _, cin_g, kh, kw = weight.shape
    groups = cin // cin_g
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    og = offset.shape[-1] // (2 * kh * kw)
    if groups * cin_g != cin or og < 1 or cin % og:
        raise ValueError(f"channels {cin} do not split into {groups} weight "
                         f"groups and {og} offset groups")
    if tuple(offset.shape[1:3]) != (ho, wo):
        raise ValueError(f"offset spatial shape {tuple(offset.shape[1:3])} "
                         f"!= ({ho}, {wo})")
    dev = x.device
    ybase = torch.arange(ho, dtype=torch.float32, device=dev) * sh - ph
    xbase = torch.arange(wo, dtype=torch.float32, device=dev) * sw - pw
    return deform_taps(x, offset, mask, weight, bias, ybase, xbase, (dh, dw))


def deform_taps(x: torch.Tensor, offset: torch.Tensor,
                mask: Optional[torch.Tensor], weight: torch.Tensor,
                bias: Optional[torch.Tensor], ybase: torch.Tensor,
                xbase: torch.Tensor, dilation: Tuple[int, int] = (1, 1)
                ) -> torch.Tensor:
    """The op's arithmetic on a given output grid: tap (i, j) of output
    pixel (r, c) samples at (ybase[r] + i * dh, xbase[c] + j * dw) plus its
    offset. `ybase` (Ho,) and `xbase` (Wo,) are float32 (exact integers);
    the other arguments are as `deform_conv2d`'s, already validated."""
    b, h, w, cin = x.shape
    cout, cin_g, kh, kw = weight.shape
    groups = cin // cin_g
    cout_g = cout // groups
    ho, wo = ybase.shape[0], xbase.shape[0]
    n_taps = kh * kw
    og = offset.shape[-1] // (2 * n_taps)
    cin_og = cin // og
    dh, dw = dilation
    dtype = x.dtype
    dev = x.device

    flat = x.float().reshape(b, h * w, cin)
    off = offset.float().reshape(b, ho, wo, og, n_taps, 2)
    msk = (None if mask is None
           else mask.float().reshape(b, ho, wo, og, n_taps))
    # (tap, group, Cin / groups, Cout / groups), rounded to the working dtype
    w_taps = weight.to(dtype).float().reshape(
        groups, cout_g, cin_g, n_taps).permute(3, 0, 2, 1).contiguous()
    ybase, xbase = ybase[:, None], xbase[None, :]

    acc = torch.zeros(b * ho * wo, cout, dtype=torch.float32, device=dev)
    for t in range(n_taps):
        i, j = divmod(t, kw)
        parts = []
        for g in range(og):
            src = flat if og == 1 else flat[..., g * cin_og:(g + 1) * cin_og]
            ty = ybase + i * dh + off[..., g, t, 0]
            tx = xbase + j * dw + off[..., g, t, 1]
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
                        wgt = wgt * msk[..., g, t]
                    wgt = wgt * inb
                    idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                    v = torch.gather(src, 1, idx.reshape(b, -1, 1).expand(
                        -1, -1, cin_og)).reshape(b, ho, wo, cin_og)
                    term = wgt[..., None] * v
                    samp = term if samp is None else samp + term
            parts.append(samp)
        samp = (parts[0] if og == 1 else torch.cat(parts, dim=-1))
        samp = samp.to(dtype).float().reshape(-1, cin)
        if groups == 1:
            acc = acc + samp @ w_taps[t, 0]
        else:
            acc = acc + torch.cat(
                [samp[:, g * cin_g:(g + 1) * cin_g] @ w_taps[t, g]
                 for g in range(groups)], dim=-1)
    if bias is not None:
        acc = acc + bias.to(dtype).float()
    return acc.reshape(b, ho, wo, cout).to(dtype)
