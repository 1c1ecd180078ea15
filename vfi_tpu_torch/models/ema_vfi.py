"""EMAVFI — the flagship two-frame midpoint model, port of
`vfi_tpu/models/ema_vfi.py` (NHWC frames in, midpoint in [0, 1] out).

Stages, as in the JAX model's fused-chain mode:
  0. self-cascade (cascade_levels > 1): the motion stages on downsampled
     copies, the flow upsampled (per-axis magnitude rescale, float32) and
     applied to frame2 as an exact unbounded pre-warp;
  1. feature extraction: plain conv 2C -> M, then the `num_blocks` M -> M
     blocks as one fused conv chain;
  2. context: two stride-2 convs, one 4M -> 4M conv, global mean, dense
     (plain PyTorch ops, XLA in the JAX package);
  3. motion: chain cat(feat, ctx) 2M -> M -> M -> 2, flow channels (dx, dy);
  4. backward warp of frame2 (RGB) by the flow, bounded to warp_max_flow
     (CUDA kernel) or exact (unbounded);
  5. fusion: optional 1x1 projection M + C -> M, then `num_blocks` bounded
     modulated DCNs, each with its offset conv as a chain of one layer;
  6. reconstruction chain M -> M -> M/2 -> C, tanh, (x + 1) / 2.

`use_kernels` picks, once, the `ops.cuda.Ops` triple the chains, the DCNs
and the bounded warp call: True, the CUDA kernel wrappers (plain versions
for CPU tensors); False, the plain versions on any device.
`pack_kernel_weights()` repacks the kernels' weights once for inference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vfi_tpu_torch.models.layers import (ConvBlock, ModulatedDeformConv,
                                         apply_conv_chain)
from vfi_tpu_torch.ops.cuda import KERNELS, PLAIN, pack_conv_chain
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.ops.warp import warp


class EMAVFI(nn.Module):
    MOTION_CHAIN = ("motion_conv1", "motion_conv2", "motion_conv3")
    REC_CHAIN = ("rec_conv1", "rec_conv2", "rec_conv3")

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 num_blocks: int = 3, dtype: Optional[torch.dtype] = None,
                 dcn_max_offset: Optional[int] = None,
                 warp_max_flow: Optional[int] = None,
                 cascade_levels: int = 1, fuse_project: bool = False,
                 use_kernels: bool = True,
                 spatial_axis: Optional[str] = None):
        super().__init__()
        if spatial_axis is not None:
            raise NotImplementedError(
                "spatial (H-sharded) mode is not ported yet")
        if dcn_max_offset is None:
            raise NotImplementedError(
                "the exact unbounded DCN (dcn_max_offset=None) is not "
                "ported yet; pass a bound such as dcn_max_offset=1")
        if cascade_levels < 1:
            raise ValueError(f"cascade_levels must be >= 1, got "
                             f"{cascade_levels}")
        m, c = mid_channels, in_channels
        self.in_channels, self.mid_channels = c, m
        self.num_blocks = num_blocks
        self.dtype = dtype
        self.warp_max_flow = warp_max_flow
        self.cascade_levels = cascade_levels
        self.fuse_project = fuse_project
        self.ops = KERNELS if use_kernels else PLAIN
        self.feat_chain = tuple(f"feat_ext_block{i}"
                                for i in range(num_blocks))
        self.packed = {}

        self.feat_ext_conv1 = ConvBlock(2 * c, m)
        for i in range(num_blocks):
            self.add_module(f"feat_ext_block{i}", ConvBlock(m, m))
        self.ctx_conv1 = ConvBlock(m, 2 * m, stride=2)
        self.ctx_conv2 = ConvBlock(2 * m, 4 * m, stride=2)
        self.ctx_conv3 = ConvBlock(4 * m, 4 * m)
        self.ctx_dense = nn.Linear(4 * m, m)
        self.motion_conv1 = ConvBlock(2 * m, m)
        self.motion_conv2 = ConvBlock(m, m)
        self.motion_conv3 = ConvBlock(m, 2, act=False)
        if fuse_project:
            self.fuse_proj = ConvBlock(m + c, m, kernel_size=1, padding=0,
                                       act=False)
            fused_ch = m
        else:
            fused_ch = m + c
        for i in range(num_blocks):
            self.add_module(f"fusion_dcn{i}",
                            ModulatedDeformConv(fused_ch, dcn_max_offset))
        self.rec_conv1 = ConvBlock(fused_ch, m)
        self.rec_conv2 = ConvBlock(m, m // 2)
        self.rec_conv3 = ConvBlock(m // 2, c, act=False)

    def _chain(self, x, names, acts):
        return apply_conv_chain(x, [getattr(self, n) for n in names], acts,
                                self.dtype, self.ops,
                                self.packed.get(names))

    def pack_kernel_weights(self) -> None:
        """Repack every chain's and DCN's weights into the kernels'
        layouts once, on the weights' device. Call it after the weights
        are loaded and moved, and again whenever they change; a model
        never packed repacks on every call."""
        for names in (self.feat_chain, self.MOTION_CHAIN, self.REC_CHAIN):
            blocks = [getattr(self, n).conv for n in names]
            self.packed[names] = pack_conv_chain(
                [c.weight for c in blocks], [c.bias for c in blocks])
        for i in range(self.num_blocks):
            getattr(self, f"fusion_dcn{i}").pack_kernel_weights()

    def _motion_stages(self, a, b2):
        """Feature extraction, context, motion -> (features, flow)."""
        feat = self.feat_ext_conv1(torch.cat([a, b2], dim=-1))
        feat = self._chain(feat, self.feat_chain, (True,) * self.num_blocks)
        ctx = self.ctx_conv3(self.ctx_conv2(self.ctx_conv1(feat)))
        ctx = ctx.mean(dim=(1, 2))
        d = self.ctx_dense
        ctx = torch.nn.functional.linear(ctx, d.weight.to(ctx.dtype),
                                         d.bias.to(ctx.dtype))
        b, h, w, _ = feat.shape
        ctx_map = ctx[:, None, None, :].expand(b, h, w, self.mid_channels)
        flow = self._chain(torch.cat([feat, ctx_map], dim=-1),
                           self.MOTION_CHAIN, (True, True, False))
        return feat, flow

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor
                ) -> torch.Tensor:
        compute = self.dtype or frame1.dtype
        f1 = frame1.to(compute)
        f2 = frame2.to(compute)
        h, w = f1.shape[1], f1.shape[2]
        for lvl in range(self.cascade_levels - 1, 0, -1):
            s = 2 ** lvl
            ch, cw = -(-h // s), -(-w // s)
            _, cflow = self._motion_stages(resize_bilinear(f1, (ch, cw)),
                                           resize_bilinear(f2, (ch, cw)))
            up = resize_bilinear(cflow.float(), (h, w))
            scale = torch.tensor([w / cw, h / ch], dtype=torch.float32,
                                 device=up.device)
            f2 = warp(f2, up * scale)

        feat, flow = self._motion_stages(f1, f2)

        if self.warp_max_flow is None:
            warped2 = warp(f2, flow)
        else:
            warped2 = self.ops.bounded_warp(f2.contiguous(), flow.contiguous(),
                                            self.warp_max_flow)

        fused = torch.cat([feat, warped2], dim=-1)
        if self.fuse_project:
            fused = self.fuse_proj(fused)
        for i in range(self.num_blocks):
            fused = getattr(self, f"fusion_dcn{i}")(fused.contiguous(),
                                                    self.ops)

        out = self._chain(fused, self.REC_CHAIN, (True, True, False))
        out = torch.tanh(out)
        return ((out + 1.0) * 0.5).to(
            torch.promote_types(frame1.dtype, torch.float32))
