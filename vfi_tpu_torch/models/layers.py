"""Layers of the port (NHWC at every forward), the counterparts of
`vfi_tpu/models/layers.py`.

Parameter names mirror the JAX tree (`<module>.conv.weight` for a
ConvBlock, `<dcn>.offset_conv.*`, `<dcn>.weight`/`.bias`), so
`utils.convert.params_from_jax` output loads with `load_state_dict`.

The chains and DCNs call through an `ops.cuda.Ops` triple: `KERNELS`
(the CUDA kernel wrappers, which run their plain versions only for CPU
tensors) or `PLAIN` (the plain versions on any device, the reference a run
on the card is held against). `conv_kernel` picks how the stride-1 3x3
convs run, as in the JAX package: "xla", each as its own plain PyTorch
conv (XLA convs there); "pallas", through the fused conv-chain kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vfi_tpu_torch.ops.cuda import (KERNELS, Ops, as_parts, cat_parts,
                                    pack_conv_chain, pack_dcn)
from vfi_tpu_torch.ops.deform_conv import deform_conv2d
from vfi_tpu_torch.utils.profiling import span

CONV_KERNELS = ("xla", "pallas")


def check_conv_kernel(conv_kernel: str) -> None:
    if conv_kernel not in CONV_KERNELS:
        raise ValueError(f"conv_kernel must be one of {CONV_KERNELS}, got "
                         f"{conv_kernel!r}")


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, act: bool) -> torch.Tensor:
    """`conv` (+ ReLU) on an NHWC tensor in its dtype, the bias added after
    the conv, as Flax's `nn.Conv` does."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), None,
                 conv.stride, conv.padding)
    y = y + conv.bias.to(x.dtype)[:, None, None]
    if act:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


class ConvBlock(nn.Module):
    """k x k conv (+ ReLU) with explicit symmetric padding, NHWC in/out
    (`vfi_tpu/models/layers.py:116`). Runs as a plain PyTorch conv in the
    input's dtype with the bias added after the conv, as Flax's `nn.Conv`
    does; with conv_kernel="pallas" the stride-1 trunk blocks run through
    `apply_conv_chain` instead."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.conv, self.act)


def apply_conv_chain(x, blocks: Sequence[ConvBlock],
                     acts: Sequence[bool], dtype=None, ops: Ops = KERNELS,
                     packed: Optional[tuple] = None) -> torch.Tensor:
    """Stride-1 3x3 conv(+ReLU) chain over the blocks' parameters
    (`vfi_tpu/models/layers.py:441`): one `conv_chain` launch on `x`, a
    tensor or its two parts along channels, as it lies (the kernel reads
    views). `packed` is `pack_conv_chain` of the blocks' parameters, or
    None."""
    parts = tuple(p.to(dtype or p.dtype) for p in as_parts(x))
    x = parts[0] if len(parts) == 1 else parts
    ws = [blk.conv.weight for blk in blocks]
    bs = [blk.conv.bias for blk in blocks]
    return ops.conv_chain(x, ws, bs, tuple(acts), packed=packed)


class ModulatedDeformConv(nn.Module):
    """Offset-predicting modulated deformable conv
    (`vfi_tpu/models/layers.py:224`).

    The offset conv (Cin -> 27, a chain of one layer) output splits into
    static | mask | dynamic groups of 9, in that order; the offsets are
    cat(static, dynamic), read as torchvision (dy, dx) pairs per tap, and
    the mask is sigmoided. Output channels == input channels. The offset
    conv runs as a plain conv (conv_kernel="xla") or as a one-layer
    conv-chain kernel launch ("pallas"). With `max_offset` an integer R
    the offsets are clamped to [-R, R] and the DCN runs through the `ops`
    triple (the bounded kernel); with None it is the exact unbounded op
    (`ops/deform_conv.py`, plain PyTorch, as in the JAX package).
    `capture`, where set to a callable, is called with the offset conv's
    raw output (B, H, W, 27) on every forward (the JAX model's
    `capture_intermediates` of `offset_conv`, for `tools/dump_offsets`).
    The forward is the host span `vfi.dcn` (`utils.profiling.span`)."""

    def __init__(self, channels: int, max_offset: Optional[int],
                 conv_kernel: str = "xla"):
        super().__init__()
        check_conv_kernel(conv_kernel)
        self.conv_kernel = conv_kernel
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
        self.capture: Optional[Callable[[torch.Tensor], None]] = None

    def pack_kernel_weights(self, dtype: torch.dtype = torch.bfloat16
                            ) -> None:
        """Repack the DCN's weights, and under conv_kernel="pallas" the
        offset conv's, into the kernels' layouts once, in `dtype` (the
        model's working dtype: the kernel instance the forward launches);
        call again after the weights change."""
        oc = self.offset_conv
        self.packed = (pack_conv_chain([oc.weight], [oc.bias], dtype)
                       if self.conv_kernel == "pallas" else None,
                       None if self.max_offset is None
                       else pack_dcn(self.weight, self.bias, dtype))

    def forward(self, x, ops: Ops = KERNELS, padded: bool = False
                ) -> torch.Tensor:
        """x: a tensor or its two parts along channels (the kernels read
        them in place; the other routes concatenate them). `padded`: the
        result goes to kernels that read views (`deform_conv2d_bounded`)."""
        with span("vfi.dcn"):
            if self.conv_kernel == "pallas":
                raw = ops.conv_chain(x, [self.offset_conv.weight],
                                     [self.offset_conv.bias], (False,),
                                     packed=self.packed[0])
            else:
                raw = conv_nhwc(cat_parts(x), self.offset_conv, act=False)
            if self.capture is not None:
                self.capture(raw)
            off_static, mask, off_dynamic = torch.split(raw, 9, dim=-1)
            offset = torch.cat([off_static, off_dynamic], dim=-1).contiguous()
            mask = torch.sigmoid(mask).contiguous()
            if self.max_offset is None:
                return deform_conv2d(cat_parts(x), offset, mask, self.weight,
                                     self.bias)
            return ops.deform_conv2d_bounded(x, offset, mask, self.weight,
                                             self.bias, self.max_offset,
                                             packed=self.packed[1],
                                             padded=padded)
