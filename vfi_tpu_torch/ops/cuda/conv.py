"""Fused stride-1 3x3 conv chain: the CUDA kernel `csrc/conv_chain.cu`
and its plain PyTorch version.

Replaces `vfi_tpu/ops/pallas/conv.py::conv_chain_pallas` (kernel
`_chain_kernel`). L layers of 3x3 conv + bias (+ ReLU where `acts[l]`),
each zero-padded on its own, float32 accumulation; the bias is rounded to
the working dtype first and every layer's output is rounded to it, as the
JAX chain (`vfi_tpu/models/layers.py::apply_conv_chain`) does.

`conv_chain(x, weights, biases, acts, packed=None)`: x NHWC, weights OIHW
(`nn.Conv2d.weight`), biases (cout,) or None; `packed` is
`pack_conv_chain(weights, biases)` made ahead of time, or None to pack on
this call. A CPU tensor runs the plain version; a CUDA tensor launches the
kernel (bf16, contiguous, first-layer channels a multiple of 16, every
cout <= 64) or raises.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from vfi_tpu_torch.ops.cuda import build

MAX_LAYERS = 4
MAX_COUT = 64


def conv_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[Optional[torch.Tensor]],
                     acts: Sequence[bool],
                     packed: Optional[tuple] = None) -> torch.Tensor:
    """The chain as L separate float32 convolutions on the working-dtype
    values (each layer rounded to x.dtype). It reads `weights`; `packed`,
    the kernel's copy of them, is taken only so that this function and
    `conv_chain` share one signature."""
    dt = x.dtype
    o = x.permute(0, 3, 1, 2)
    for w, b, a in zip(weights, biases, acts):
        y = F.conv2d(o.float(), w.to(dt).float(), padding=1)
        if b is not None:
            y = y + b.to(dt).float()[:, None, None]
        if a:
            y = torch.relu(y)
        o = y.to(dt)
    return o.permute(0, 2, 3, 1).contiguous()


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def pack_conv_chain(weights: Sequence[torch.Tensor],
                    biases: Sequence[Optional[torch.Tensor]]) -> tuple:
    """The kernel's weight layout: weights -> one bf16 buffer of per-layer
    [9][cin_p][cout_p] blocks, biases -> one f32 buffer of per-layer
    [cout_p] (bf16-rounded values); padded channels are zero. A module
    whose weights stay fixed packs them once and passes the result as
    `conv_chain(..., packed=)`."""
    dev = weights[0].device
    wblocks, bblocks = [], []
    cin_p = weights[0].shape[1]
    for w, b in zip(weights, biases):
        cout, cin = w.shape[0], w.shape[1]
        cout_p = _pad16(cout)
        blk = torch.zeros(9, cin_p, cout_p, dtype=torch.bfloat16, device=dev)
        blk[:, :cin, :cout] = w.detach().permute(2, 3, 1, 0).reshape(
            9, cin, cout)
        wblocks.append(blk.reshape(-1))
        bb = torch.zeros(cout_p, dtype=torch.float32, device=dev)
        if b is not None:
            bb[:cout] = b.detach().to(torch.bfloat16).float()
        bblocks.append(bb)
        cin_p = cout_p
    return torch.cat(wblocks), torch.cat(bblocks)


def conv_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[Optional[torch.Tensor]],
               acts: Sequence[bool],
               packed: Optional[tuple] = None) -> torch.Tensor:
    weights, biases, acts = list(weights), list(biases), list(acts)
    if not (len(weights) == len(biases) == len(acts)):
        raise ValueError("weights, biases and acts differ in length")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    chans = [x.shape[3]]
    for w in weights:
        if w.dim() != 4 or w.shape[2:] != (3, 3) or w.shape[1] != chans[-1]:
            raise ValueError(f"layer weight {tuple(w.shape)} is not OIHW "
                             f"3x3 with cin={chans[-1]}")
        chans.append(w.shape[0])
    if x.device.type == "cpu":
        return conv_chain_plain(x, weights, biases, acts)
    if x.device.type != "cuda":
        raise ValueError(f"conv_chain: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv_chain kernel takes bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv_chain kernel takes a contiguous NHWC tensor")
    L = len(weights)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"conv_chain kernel takes 1..{MAX_LAYERS} layers")
    if chans[0] % 16 != 0:
        raise ValueError(f"conv_chain kernel needs first-layer channels % 16"
                         f" == 0, got {chans[0]}")
    if max(chans[1:]) > MAX_COUT:
        raise ValueError(f"conv_chain kernel takes cout <= {MAX_COUT}")
    if any(w.device != x.device for w in weights):
        raise ValueError("weights must be on the input's device")
    b, h, w, _ = x.shape
    wpk, bpk = packed or pack_conv_chain(weights, biases)
    n_w = sum(9 * _pad16(ci) * _pad16(co) for ci, co in
              zip([chans[0]] + chans[1:-1], chans[1:]))
    if wpk.numel() != n_w or wpk.device != x.device:
        raise ValueError("packed weights do not match this chain's "
                         "channels or device")
    out = torch.empty(b, h, w, chans[-1], dtype=torch.bfloat16,
                      device=x.device)
    cs = chans + [0] * (MAX_LAYERS + 1 - len(chans))
    act_mask = sum(1 << i for i, a in enumerate(acts) if a)
    lib = build.load()
    rc = lib.vfi_conv_chain_bf16(
        x.data_ptr(), wpk.data_ptr(), bpk.data_ptr(), out.data_ptr(),
        b, h, w, L, *cs, act_mask, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "conv_chain")
    conv_chain.launches += 1
    conv_chain.launches_by_shape[(tuple(chans), h, w)] += 1
    return out


conv_chain.launches = 0
conv_chain.launches_by_shape = Counter()
