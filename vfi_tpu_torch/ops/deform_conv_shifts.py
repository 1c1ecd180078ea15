"""Bounded modulated deformable conv (DCNv2), plain PyTorch — the port of
`vfi_tpu/ops/deform_conv_shifts.py` and the plain version of the CUDA
kernel `csrc/dcn_bounded.cu` (`ops/cuda/sampling.deform_conv2d_bounded`).

Per output pixel p and 3x3 tap t: clamp the tap's learned offset (dy, dx)
to [-R, R] in float32, then run the exact op's arithmetic
(`ops/deform_conv.deform_taps`) on the input's own grid: bilinear-sample x
at p + tap + offset (corners outside the image read 0), scale by the
tap's mask, and contract Cin -> Cout with weight[tap]; sum the taps and
add the bias. Offsets use torchvision's layout: channels (2t, 2t+1) =
(dy, dx) of tap t = 3i + j.

Numerics: the sample weights and blends are float32; the blended sample
(the modulated sample matrix, one Cin row per tap) is held in the working
dtype — as the TPU kernels hold their sample buffer — and the contraction
accumulates in float32 and rounds once. In float32 this is the JAX op's
function to float32 rounding. The JAX shifts op in bf16 also accumulates
the taps in bf16; this version does not.

`deform_conv2d_shifts_bwd` is the hand-written backward of the same
function, the port of the JAX function of that name: the gradients for a
cotangent, without a recomputed forward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vfi_tpu_torch.ops.deform_conv import deform_taps


def deform_conv2d_shifts(x: torch.Tensor, offset: torch.Tensor,
                         mask: Optional[torch.Tensor], weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         max_offset: int = 3,
                         padding: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin); offset (B, H, W, 2*kh*kw); mask (B, H, W, kh*kw)
    or None; weight OIHW (Cout, Cin, kh, kw); bias (Cout,) or None.
    Stride 1, one offset group. Returns (B, H, W, Cout) in x's dtype."""
    _, cin_w, kh, kw = weight.shape
    if cin_w != x.shape[-1]:
        raise ValueError("deform_conv2d_shifts supports groups == 1 only")
    if offset.shape[-1] != 2 * kh * kw:
        raise ValueError("deform_conv2d_shifts supports one offset group only")
    r = float(int(max_offset))
    grid = [torch.arange(n, dtype=torch.float32, device=x.device) - padding
            for n in x.shape[1:3]]
    return deform_taps(x, offset.float().clamp(-r, r), mask, weight, bias,
                       *grid)


def deform_conv2d_shifts_bwd(x: torch.Tensor, offset: torch.Tensor,
                             mask: Optional[torch.Tensor],
                             weight: torch.Tensor,
                             bias: Optional[torch.Tensor], g: torch.Tensor,
                             max_offset: int = 3, padding: int = 1) -> tuple:
    """Hand-written VJP of `deform_conv2d_shifts` for the cotangent `g`
    (B, H, W, Cout): returns (dx, doffset, dmask or None, dweight, dbias or
    None) in the dtypes of x, offset, mask, weight (OIHW) and bias; every
    sum is float32.

    The gradients are those of the JAX function `deform_conv2d_shifts_bwd`
    (`vfi_tpu/ops/deform_conv_shifts.py`), which differentiates the sample
    as a sum of tent weights tri(v) = clip(1 - |v|, 0, 1) over integer
    shifts: tri has slope -sign(v) on 0 < |v| < 1 and 0 elsewhere, so the
    offset gradient on an axis is 0 where the clamped sample coordinate is
    an integer; the clamp to [-R, R] passes the gradient on the closed
    interval |offset| <= R; taps outside the image read 0. This form
    gathers the four corners around floor(coordinate), which are the only
    shifts with a nonzero tent weight or slope.

    This is not the gradient autograd gives through `deform_conv2d_shifts`
    at integer coordinates: there the forward's floor makes the bilinear
    blend one-sided, and autograd takes that side's slope (nonzero), as
    the exact op `ops/deform_conv.py` does. Away from integer coordinates
    and the clamp's ends the two agree."""
    b, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    n_taps = kh * kw
    R = int(max_offset)
    # Zero borders that hold every corner a clamped tap can reach: row
    # floor(r + i - padding + d) >= r - padding - R, and its lower
    # neighbour <= r + kh - padding + R (columns alike).
    lo, hi_h, hi_w = padding + R, kh - padding + R, kw - padding + R
    xp = F.pad(x.float(), (0, 0, lo, hi_w, lo, hi_h))
    hp, wp = xp.shape[1:3]
    xf = xp.reshape(-1, cin)
    dxf = torch.zeros_like(xf)
    dev = x.device
    # flat index of (batch, row, column) in the padded image, before the
    # tap's corner
    pix = ((torch.arange(b, device=dev) * hp)[:, None, None]
           + torch.arange(h, device=dev)[None, :, None] + lo) * wp \
        + torch.arange(w, device=dev)[None, None, :] + lo
    off = offset.float().reshape(b, h, w, n_taps, 2)
    msk = None if mask is None else mask.float().reshape(b, h, w, n_taps)
    g32 = g.float()
    wt = weight.float()
    dw = torch.zeros(cout, cin, kh, kw, dtype=torch.float32, device=dev)
    doff = torch.zeros(b, h, w, n_taps, 2, dtype=torch.float32, device=dev)
    dmask = None if msk is None else torch.zeros(b, h, w, n_taps,
                                                 dtype=torch.float32,
                                                 device=dev)
    for t in range(n_taps):
        i, j = divmod(t, kw)
        oy, ox = off[..., t, 0], off[..., t, 1]
        # the tap's coordinate relative to the output pixel, split into
        # its integer part (exact) and fraction as the tent weights see it
        ty = oy.clamp(-R, R) + (i - padding)
        tx = ox.clamp(-R, R) + (j - padding)
        y0, x0 = torch.floor(ty), torch.floor(tx)
        fy, fx = ty - y0, tx - x0
        i00 = pix + y0.long() * wp + x0.long()
        corners = (i00, i00 + 1, i00 + wp, i00 + wp + 1)
        x00, x01, x10, x11 = (xf[c] for c in corners)
        wy0, wy1, wx0, wx1 = ((1.0 - fy)[..., None], fy[..., None],
                              (1.0 - fx)[..., None], fx[..., None])
        samp = wy0 * (wx0 * x00 + wx1 * x01) + wy1 * (wx0 * x10 + wx1 * x11)
        q = g32 @ wt[:, :, i, j]                     # (B, H, W, Cin)
        dsamp = q if msk is None else q * msk[..., t, None]
        macc = samp if msk is None else samp * msk[..., t, None]
        dw[:, :, i, j] = torch.einsum("bhwo,bhwc->oc", g32, macc)
        if dmask is not None:
            dmask[..., t] = (q * samp).sum(-1)
        dty = (dsamp * (wx0 * (x10 - x00) + wx1 * (x11 - x01))).sum(-1)
        dtx = (dsamp * (wy0 * (x01 - x00) + wy1 * (x11 - x10))).sum(-1)
        doff[..., t, 0] = dty * ((fy > 0) & (oy.abs() <= R))
        doff[..., t, 1] = dtx * ((fx > 0) & (ox.abs() <= R))
        for c, wgt in zip(corners, (wy0 * wx0, wy0 * wx1, wy1 * wx0,
                                    wy1 * wx1)):
            dxf.index_add_(0, c.reshape(-1), (wgt * dsamp).reshape(-1, cin))
    dx = dxf.reshape(b, hp, wp, cin)[:, lo:lo + h, lo:lo + w]
    return (dx.to(x.dtype), doff.reshape(offset.shape).to(offset.dtype),
            None if dmask is None else dmask.to(mask.dtype),
            dw.to(weight.dtype),
            None if bias is None else g32.sum((0, 1, 2)).to(bias.dtype))
