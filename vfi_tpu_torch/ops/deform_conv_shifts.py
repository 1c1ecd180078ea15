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
"""

from __future__ import annotations

from typing import Optional

import torch

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
