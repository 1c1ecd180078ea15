"""EMAVFI — the flagship two-frame midpoint model, port of
`vfi_tpu/models/ema_vfi.py` (NHWC frames in, midpoint in [0, 1] out).

Stages, as in the JAX model (its fused-chain mode with
conv_kernel="pallas"):
  0. self-cascade (cascade_levels > 1): the motion stages on downsampled
     copies, the flow upsampled (per-axis magnitude rescale, float32) and
     applied to frame2 as an exact unbounded pre-warp;
  1. feature extraction: plain conv 2C -> M, then the `num_blocks` M -> M
     blocks (one fused conv chain under conv_kernel="pallas");
  2. context: two stride-2 convs, one 4M -> 4M conv, global mean, dense
     (plain PyTorch ops, XLA in the JAX package);
  3. motion: chain cat(feat, ctx) 2M -> M -> M -> 2, flow channels (dx, dy);
  4. backward warp of frame2 (RGB) by the flow, bounded to warp_max_flow
     (CUDA kernel) or exact (unbounded);
  5. fusion: optional 1x1 projection M + C -> M, then `num_blocks`
     modulated DCNs, each with its offset conv as a chain of one layer,
     offsets bounded to dcn_max_offset (CUDA kernel) or exact (None:
     unbounded, plain PyTorch);
  6. reconstruction chain M -> M -> M/2 -> C, tanh, (x + 1) / 2.

`conv_kernel` ("xla", the JAX default, or "pallas") picks how the trunk
chains (feature blocks, motion, reconstruction) and each DCN's offset conv
run: as separate plain convs, or each chain as one conv-chain kernel
launch. `use_kernels` picks, once, the `ops.cuda.Ops` triple the chains,
the DCNs and the bounded warp call: True, the CUDA kernel wrappers (plain
versions for CPU tensors); False, the plain versions on any device. The bounded DCN and warp always go through that
choice: the JAX model's `use_pallas` and `dcn_kernel` (the XLA shifts op,
v4 and v5 compute one function) have no counterpart here.
`pack_kernel_weights()` repacks the kernels' weights once for inference.

Inputs in parts (`_reads_parts`): with the kernels under
conv_kernel="pallas", for a bf16 CUDA forward outside spatial mode with no
gradient to record (`ops.cuda.reads_views`), the model builds no channel
concatenation for the kernels, and asks the bounded warp and the DCNs for
padded outputs (`padded=True`). The motion chain's first layer reads
(features, the context vector broadcast over the pixels); the fusion reads
(features, the warped frame's 8-wide buffer), through the fuse projection
on the conv kernel (`ops.conv2d`: the bias added in float32 before one
rounding, where the plain conv rounds twice) or, without it, through the
first DCN and its offset conv; a DCN's 67-wide output is the view of its
72-wide buffer that the next DCN and the reconstruction read in place.
Every other forward (CPU, float32, spatial mode, training,
conv_kernel="xla", the plain versions) concatenates, as the JAX model
does; so does the fusion after an exact warp.

Spatial mode (`spatial_global_h` set; `with_spatial` makes such a copy
sharing the weights), the counterpart of the JAX model's `spatial_axis`:
each rank of `spatial_group` (a `torch.distributed` group, None: the
default one) passes a halo-extended slab of a `spatial_global_h`-row frame
pair (slab row 0 is global row rank * H_local - `spatial_halo`). Every
row-mixing layer's output is masked to zero on rows outside the image, so
each layer sees the one-device zero padding; the trunk then runs layer by
layer (a chain of one layer each under conv_kernel="pallas", the conv
kernel `csrc/conv2d.cu`), since a chain would not mask between its layers.
The context pool sums the rows the rank owns (float32, `all_reduce` over
the group) and divides by the global pooled extent; the cascade's coarse
pass and pre-warp run on the gathered global pair (`all_gather`), then the
rank cuts its slab again. `parallel/spatial.py` owns the halo and height
contract.

Host spans (`utils.profiling.span`, recorded only under a profiler): each
coarse level `vfi.cascade`; stages 1-3 `vfi.features`, `vfi.context`,
`vfi.motion` (inside `vfi.cascade` on a coarse pass); stage 4 `vfi.warp`;
stage 5 `vfi.fusion`, each DCN inside it `vfi.dcn`; stage 6
`vfi.reconstruct`.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vfi_tpu_torch.models.layers import (ConvBlock, ModulatedDeformConv,
                                         apply_conv_chain, check_conv_kernel)
from vfi_tpu_torch.ops.cuda import (KERNELS, PLAIN, pack_conv2d,
                                    pack_conv_chain, reads_views)
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.ops.warp import warp
from vfi_tpu_torch.parallel import comm
from vfi_tpu_torch.utils.profiling import span


def _identity(x, scale=1):
    return x


class EMAVFI(nn.Module):
    MOTION_CHAIN = ("motion_conv1", "motion_conv2", "motion_conv3")
    REC_CHAIN = ("rec_conv1", "rec_conv2", "rec_conv3")

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 num_blocks: int = 3, dtype: Optional[torch.dtype] = None,
                 dcn_max_offset: Optional[int] = None,
                 warp_max_flow: Optional[int] = None,
                 cascade_levels: int = 1, fuse_project: bool = False,
                 conv_kernel: str = "xla", use_kernels: bool = True,
                 spatial_group=None, spatial_halo: int = 0,
                 spatial_global_h: Optional[int] = None):
        super().__init__()
        if cascade_levels < 1:
            raise ValueError(f"cascade_levels must be >= 1, got "
                             f"{cascade_levels}")
        check_conv_kernel(conv_kernel)
        m, c = mid_channels, in_channels
        self.in_channels, self.mid_channels = c, m
        self.num_blocks = num_blocks
        self.dtype = dtype
        self.warp_max_flow = warp_max_flow
        self.cascade_levels = cascade_levels
        self.fuse_project = fuse_project
        self.conv_kernel = conv_kernel
        self.ops = KERNELS if use_kernels else PLAIN
        self.feat_chain = tuple(f"feat_ext_block{i}"
                                for i in range(num_blocks))
        self.packed = {}
        self.fuse_packed = None
        self.spatial_group = spatial_group
        self.spatial_halo = spatial_halo
        self.spatial_global_h = spatial_global_h

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
                            ModulatedDeformConv(fused_ch, dcn_max_offset,
                                                conv_kernel))
        self.rec_conv1 = ConvBlock(fused_ch, m)
        self.rec_conv2 = ConvBlock(m, m // 2)
        self.rec_conv3 = ConvBlock(m // 2, c, act=False)

    def with_spatial(self, group, halo: int, global_h: int) -> "EMAVFI":
        """A copy in spatial mode over `group` that shares this model's
        parameters (the JAX model's `clone(spatial_axis=...)`); packed
        again, for its layers, where this model was packed."""
        clone = copy.copy(self)
        clone.spatial_group, clone.spatial_halo = group, halo
        clone.spatial_global_h = global_h
        clone.packed = {}
        if self.packed:
            clone.pack_kernel_weights()
        return clone

    def _row_tools(self):
        """Spatial mode's (mask, owner_mask): `mask(x, scale)` zeroes the
        slab rows outside the global image at full resolution (scale 1) or
        a context stride (2, 4); `owner_mask(x, scale)` keeps only the rows
        this rank owns, a partition of the image over the ranks."""
        s = comm.rank(self.spatial_group)
        h_local = self.spatial_global_h // comm.size(self.spatial_group)
        origin = s * h_local - self.spatial_halo   # global row of slab row 0

        def _valid(x, scale, lo, hi):
            rows = torch.arange(x.shape[1], device=x.device) + origin // scale
            keep = ((rows >= lo) & (rows < hi)).to(x.dtype)
            return x * keep[None, :, None, None]

        def mask(x, scale=1):
            return _valid(x, scale, 0, self.spatial_global_h // scale)

        def owner_mask(x, scale):
            return _valid(x, scale, s * (h_local // scale),
                          (s + 1) * (h_local // scale))

        return mask, owner_mask

    def _chain(self, x, names, acts, mask=None, mask_last=True):
        """Stride-1 3x3 conv(+ReLU) blocks `names`. With `mask` None: one
        conv-chain launch under conv_kernel="pallas", else each block as
        its own conv (the `acts` are the blocks' own). With a `mask`
        (spatial mode): layer by layer, each output masked (the last only
        with `mask_last`), a layer a one-layer chain under "pallas"."""
        pallas = self.conv_kernel == "pallas"
        if mask is None and pallas:
            return apply_conv_chain(x, [getattr(self, n) for n in names],
                                    acts, self.dtype, self.ops,
                                    self.packed.get(names))
        x = x.to(self.dtype or x.dtype)
        for i, (n, act) in enumerate(zip(names, acts)):
            if pallas:
                x = apply_conv_chain(x, [getattr(self, n)], (act,),
                                     self.dtype, self.ops,
                                     self.packed.get((n,)))
            else:
                x = getattr(self, n)(x)
            if mask is not None and (mask_last or i < len(names) - 1):
                x = mask(x)
        return x

    def _reads_parts(self, x: torch.Tensor) -> bool:
        """Whether a forward of input `x` hands the kernels concatenations
        as parts and views, and asks the bounded warp and the DCNs for
        padded outputs (the module docstring's "Inputs in parts"): the
        kernels under conv_kernel "pallas", no spatial mode, and the path
        on which they read in place (`ops.cuda.reads_views`: a bf16 CUDA
        input, no gradient to record). Decided on what the forward
        observes."""
        return (self.conv_kernel == "pallas" and self.ops is KERNELS
                and self.spatial_global_h is None
                and reads_views(x, *self.parameters()))

    def pack_kernel_weights(self) -> None:
        """Repack the DCNs' weights, and under conv_kernel="pallas" every
        chain's (in spatial mode, which runs the layers one by one, every
        trunk layer's too) and the fuse projection's (`fuse_packed`, for
        the conv kernel), into the kernels' layouts once, on the
        weights' device, in the working dtype (`dtype`, or float32 for a
        model without one: the kernel instance its forward launches). Call
        it after the weights are loaded and moved, and again whenever they
        change; a model never packed repacks on every call."""
        dt = self.dtype or torch.float32
        if self.conv_kernel == "pallas":
            if self.fuse_project:
                fp = self.fuse_proj.conv
                self.fuse_packed = pack_conv2d(fp.weight, fp.bias, dt)
            for names in (self.feat_chain, self.MOTION_CHAIN,
                          self.REC_CHAIN):
                blocks = [getattr(self, n).conv for n in names]
                self.packed[names] = pack_conv_chain(
                    [c.weight for c in blocks], [c.bias for c in blocks], dt)
                if self.spatial_global_h is None:
                    continue
                for n, c in zip(names, blocks):
                    self.packed[(n,)] = pack_conv_chain([c.weight], [c.bias],
                                                        dt)
        for i in range(self.num_blocks):
            getattr(self, f"fusion_dcn{i}").pack_kernel_weights(dt)

    def _motion_stages(self, a, b2, mask=None, owner_mask=None,
                       parts=False):
        """Feature extraction, context, motion -> (features, flow). In
        spatial mode `mask` masks each layer's rows (identity on the
        cascade's global coarse pass) and `owner_mask`, where given,
        makes the context pool a sum over the ranks' owned rows. With
        `parts` the motion chain reads (features, broadcast context)."""
        layer_mask = mask
        mask = mask or _identity
        with span("vfi.features"):
            feat = mask(self.feat_ext_conv1(torch.cat([a, b2], dim=-1)))
            feat = self._chain(feat, self.feat_chain,
                               (True,) * self.num_blocks, layer_mask)
        with span("vfi.context"):
            ctx = mask(self.ctx_conv1(feat), 2)
            ctx = self.ctx_conv3(mask(self.ctx_conv2(ctx), 4))
            if owner_mask is not None:
                # The exact global mean: every rank sums the rows it owns,
                # the sums add over the group, over the global pooled
                # extent.
                pooled = comm.all_reduce_sum(
                    owner_mask(ctx, 4).float().sum(dim=(1, 2)),
                    self.spatial_group)
                count = (self.spatial_global_h // 4) * ctx.shape[2]
                ctx = (pooled / count).to(ctx.dtype)
            else:
                ctx = ctx.mean(dim=(1, 2))
            d = self.ctx_dense
            ctx = torch.nn.functional.linear(ctx, d.weight.to(ctx.dtype),
                                             d.bias.to(ctx.dtype))
        with span("vfi.motion"):
            b, h, w, _ = feat.shape
            ctx_map = ctx[:, None, None, :].expand(b, h, w,
                                                   self.mid_channels)
            # (spatial mode: the broadcast context is nonzero on rows
            # outside the image; the mask restores the zero padding there)
            x = ((feat, ctx_map) if parts
                 else mask(torch.cat([feat, ctx_map], dim=-1)))
            flow = self._chain(x, self.MOTION_CHAIN, (True, True, False),
                               layer_mask)
        return feat, flow

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor
                ) -> torch.Tensor:
        compute = self.dtype or frame1.dtype
        f1 = frame1.to(compute)
        f2 = frame2.to(compute)
        spatial = self.spatial_global_h is not None
        parts = self._reads_parts(f1)
        if spatial:
            mask, owner_mask = self._row_tools()
            f1, f2 = mask(f1), mask(f2)
            halo, group = self.spatial_halo, self.spatial_group
            h_local = self.spatial_global_h // comm.size(group)
            start = comm.rank(group) * h_local
            h, w = self.spatial_global_h, f1.shape[2]
        else:
            mask, owner_mask = _identity, None
            h, w = f1.shape[1], f1.shape[2]
        for lvl in range(self.cascade_levels - 1, 0, -1):
            with span("vfi.cascade"):
                s = 2 ** lvl
                ch, cw = -(-h // s), -(-w // s)
                if spatial:
                    # The coarse pass and the unbounded pre-warp run on the
                    # global pair, gathered from the ranks' owned rows, with
                    # no mask; each rank then cuts its slab of the warped
                    # frame.
                    g1, g2 = (comm.all_gather_rows(
                        x[:, halo:halo + h_local], group) for x in (f1, f2))
                else:
                    g1, g2 = f1, f2
                _, cflow = self._motion_stages(
                    resize_bilinear(g1, (ch, cw)),
                    resize_bilinear(g2, (ch, cw)),
                    _identity if spatial else None, parts=parts)
                # The flow to the fine grid, x by w / cw and y by h / ch:
                # each Python float rounds to float32 as a float32 tensor
                # of it would, with no host-to-device copy (a CUDA graph
                # may capture this).
                up = resize_bilinear(cflow.float(), (h, w))
                up[..., 0] *= w / cw
                up[..., 1] *= h / ch
                f2 = warp(g2, up)
                if spatial:
                    f2 = F.pad(f2, (0, 0, 0, 0, halo, halo))
                    f2 = mask(f2[:, start:start + h_local + 2 * halo])

        feat, flow = self._motion_stages(f1, f2, mask if spatial else None,
                                         owner_mask, parts)

        with span("vfi.warp"):
            if self.warp_max_flow is None:
                warped2 = warp(f2, flow)
            else:
                warped2 = self.ops.bounded_warp(f2.contiguous(),
                                                flow.contiguous(),
                                                self.warp_max_flow,
                                                padded=parts)

        with span("vfi.fusion"):
            if parts and self.warp_max_flow is not None:
                fused = (feat, warped2)   # the bounded warp's 8-wide view
                if self.fuse_project:
                    fp = self.fuse_proj.conv
                    fused = self.ops.conv2d(fused, fp.weight, fp.bias,
                                            packed=self.fuse_packed)
            else:
                fused = mask(torch.cat([feat, warped2], dim=-1))
                if self.fuse_project:
                    fused = mask(self.fuse_proj(fused))
            for i in range(self.num_blocks):
                fused = mask(getattr(self, f"fusion_dcn{i}")(
                    fused, self.ops, padded=parts))

        with span("vfi.reconstruct"):
            out = self._chain(fused, self.REC_CHAIN, (True, True, False),
                              mask if spatial else None, mask_last=False)
            out = torch.tanh(out)
            return ((out + 1.0) * 0.5).to(
                torch.promote_types(frame1.dtype, torch.float32))
