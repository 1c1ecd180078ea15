"""SimpleFlowNet — the compact coarse-to-fine flow estimator, port of
`vfi_tpu/models/flownet.py`. Plain PyTorch convs (XLA convs in the JAX
package). Output (B, H, W, 2) flow, channels (dx, dy), such that
warp(frame1, flow) ~ frame0."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vfi_tpu_torch.models.layers import ConvBlock
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.ops.warp import warp


class _LevelNet(nn.Module):
    def __init__(self, cin: int, mid: int):
        super().__init__()
        self.c1 = ConvBlock(cin, mid)
        self.c2 = ConvBlock(mid, mid)
        self.flow = ConvBlock(mid, 2, act=False)

    def forward(self, x):
        return self.flow(self.c2(self.c1(x)))


class SimpleFlowNet(nn.Module):
    """3-level pyramid: each level warps frame1 by the upsampled coarse
    flow and predicts a residual from cat(frame0, warped frame1, flow)."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 32,
                 levels: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.levels = levels
        self.dtype = dtype
        for lvl in range(levels):
            self.add_module(f"level{lvl}",
                            _LevelNet(2 * in_channels + 2, mid_channels))

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor
                ) -> torch.Tensor:
        b, h, w, _ = frame0.shape
        compute = self.dtype or frame0.dtype
        f0 = frame0.to(compute)
        f1 = frame1.to(compute)
        sizes = [(h >> k, w >> k) for k in range(self.levels - 1, -1, -1)]
        flow = None
        for lvl, (lh, lw) in enumerate(sizes):
            p0 = resize_bilinear(f0, (lh, lw)) if (lh, lw) != (h, w) else f0
            p1 = resize_bilinear(f1, (lh, lw)) if (lh, lw) != (h, w) else f1
            if flow is None:
                flow = torch.zeros(b, lh, lw, 2, dtype=compute,
                                   device=f0.device)
            else:
                scale_h = lh / flow.shape[1]
                flow = resize_bilinear(flow, (lh, lw)) * scale_h
            p1w = warp(p1, flow)
            residual = getattr(self, f"level{lvl}")(
                torch.cat([p0, p1w, flow], dim=-1))
            flow = flow + residual
        return flow.to(torch.promote_types(frame0.dtype, torch.float32))
