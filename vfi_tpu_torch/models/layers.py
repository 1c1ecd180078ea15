"""Layers of the port (NHWC at every forward), the counterparts of
`vfi_tpu/models/layers.py`.

Parameter names mirror the JAX tree (`<module>.conv.weight` for a
ConvBlock, `<dcn>.offset_conv.*`, `<dcn>.weight`/`.bias`), so
`utils.convert.params_from_jax` output loads with `load_state_dict`.

The chains and DCNs call through an `ops.cuda.Ops` triple: `KERNELS`
(the CUDA kernel wrappers, which run their plain versions only for CPU
tensors) or `PLAIN` (the plain versions on any device, the reference a run
on the card is held against).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vfi_tpu_torch.ops.cuda import (KERNELS, Ops, pack_conv_chain,
                                    pack_dcn)


class ConvBlock(nn.Module):
    """k x k conv (+ ReLU) with explicit symmetric padding, NHWC in/out
    (`vfi_tpu/models/layers.py:116`). Runs as a plain PyTorch conv in the
    input's dtype with the bias added after the conv, as Flax's `nn.Conv`
    does; the stride-1 trunk blocks run through `apply_conv_chain`
    instead."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv2d(x.permute(0, 3, 1, 2), c.weight.to(x.dtype), None,
                     c.stride, c.padding)
        y = y + c.bias.to(x.dtype)[:, None, None]
        if self.act:
            y = torch.relu(y)
        return y.permute(0, 2, 3, 1).contiguous()


def apply_conv_chain(x: torch.Tensor, blocks: Sequence[ConvBlock],
                     acts: Sequence[bool], dtype=None, ops: Ops = KERNELS,
                     packed: Optional[tuple] = None) -> torch.Tensor:
    """Stride-1 3x3 conv(+ReLU) chain over the blocks' parameters
    (`vfi_tpu/models/layers.py:441`): one `conv_chain` launch. `packed`
    is `pack_conv_chain` of the blocks' parameters, or None."""
    x = x.to(dtype or x.dtype).contiguous()
    ws = [blk.conv.weight for blk in blocks]
    bs = [blk.conv.bias for blk in blocks]
    return ops.conv_chain(x, ws, bs, tuple(acts), packed=packed)


class ModulatedDeformConv(nn.Module):
    """Offset-predicting modulated deformable conv, bounded offsets
    (`vfi_tpu/models/layers.py:224`).

    The offset conv (Cin -> 27, a chain of one layer) output splits into
    static | mask | dynamic groups of 9, in that order; the offsets are
    cat(static, dynamic), read as torchvision (dy, dx) pairs per tap, and
    the mask is sigmoided. Output channels == input channels."""

    def __init__(self, channels: int, max_offset: int):
        super().__init__()
        self.offset_conv = nn.Conv2d(channels, 27, 3, 1, 1)
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(channels))
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        bound = 1.0 / (channels * 9) ** 0.5
        nn.init.uniform_(self.bias, -bound, bound)
        self.max_offset = max_offset
        self.packed = (None, None)

    def pack_kernel_weights(self) -> None:
        """Repack the offset conv's and the DCN's weights into the
        kernels' layouts once; call again after the weights change."""
        oc = self.offset_conv
        self.packed = (pack_conv_chain([oc.weight], [oc.bias]),
                       pack_dcn(self.weight, self.bias))

    def forward(self, x: torch.Tensor, ops: Ops = KERNELS) -> torch.Tensor:
        raw = ops.conv_chain(x, [self.offset_conv.weight],
                             [self.offset_conv.bias], (False,),
                             packed=self.packed[0])
        off_static, mask, off_dynamic = torch.split(raw, 9, dim=-1)
        offset = torch.cat([off_static, off_dynamic], dim=-1).contiguous()
        mask = torch.sigmoid(mask).contiguous()
        return ops.deform_conv2d_bounded(x, offset, mask, self.weight,
                                         self.bias, self.max_offset,
                                         packed=self.packed[1])
