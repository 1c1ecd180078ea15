"""Bounded sampling kernels: the CUDA kernels `csrc/dcn_bounded.cu` and
`csrc/warp_bounded.cu`, with their plain PyTorch versions.

- `deform_conv2d_bounded` replaces
  `vfi_tpu/ops/pallas/sampling.py::deform_conv2d_pallas_v4` (kernel
  `_sampling_kernel_v4`) and `deform_conv2d_pallas_v5`
  (`_sampling_kernel_v5`), which compute one function under v4's
  contract: modulated DCNv2, stride 1, one offset group, offsets clamped
  to [-R, R], any Cin, Cout up to 128, an optional mask (None: weight 1).
  Plain version: `ops/deform_conv_shifts.deform_conv2d_shifts`.
- `bounded_warp` replaces `bounded_warp_pallas_v2` (kernel
  `_warp_kernel_v2`): backward warp by the flow clipped to [-R, R].
  Plain version: `ops/warp.warp(image, clip(flow))`.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(bf16, contiguous) or raises. `tile_w` is accepted for API parity with
the JAX wrappers (a TPU skip-predicate tiling knob) and has no effect on
the output.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from vfi_tpu_torch.ops.cuda import build
from vfi_tpu_torch.ops.cuda.conv import _pad16, pad_channels8
from vfi_tpu_torch.ops.deform_conv_shifts import deform_conv2d_shifts
from vfi_tpu_torch.ops.warp import warp

DCN_MAX_COUT = 128


def deform_conv2d_bounded_plain(x, offset, mask, weight, bias=None,
                                max_offset: int = 3,
                                packed: Optional[tuple] = None
                                ) -> torch.Tensor:
    """Reads `weight` and `bias`; `packed`, the kernel's copy of them, is
    taken only so that this function and `deform_conv2d_bounded` share one
    signature."""
    return deform_conv2d_shifts(x, offset, mask, weight, bias,
                                max_offset=max_offset, padding=1)


def bounded_warp_plain(image: torch.Tensor, flow: torch.Tensor,
                       max_flow: int = 16) -> torch.Tensor:
    r = float(max_flow)
    return warp(image, flow.clamp(-r, r))


def _cuda_checks(name: str, **tensors) -> torch.device:
    dev = None
    for k, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {k} on {t.device}, expected cuda")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16 {k}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes a contiguous {k}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
    return dev


def pack_dcn(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> tuple:
    """The kernel's weight layout: OIHW -> bf16 [9 * Cin16][Cout16]
    (tap-major, channels padded to multiples of 16 with zeros), bias -> f32
    [Cout16] (bf16-rounded values, zeros for None and the padding). A
    module whose weights stay fixed packs them once and passes the result
    as `deform_conv2d_bounded(..., packed=)`."""
    cout, cin = weight.shape[:2]
    cin16, cout16 = _pad16(cin), _pad16(cout)
    dev = weight.device
    wpk = torch.zeros(9, cin16, cout16, dtype=torch.bfloat16, device=dev)
    wpk[:, :cin, :cout] = weight.detach().to(torch.bfloat16).permute(
        2, 3, 1, 0).reshape(9, cin, cout)
    bpk = torch.zeros(cout16, dtype=torch.float32, device=dev)
    if bias is not None:
        bpk[:cout] = bias.detach().to(torch.bfloat16).float()
    return wpk.reshape(9 * cin16, cout16), bpk


def deform_conv2d_bounded(x: torch.Tensor, offset: torch.Tensor,
                          mask: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          max_offset: int = 3,
                          tile_w: Optional[int] = None,
                          packed: Optional[tuple] = None) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC; offset (B, H, W, 18) as (dy, dx) per tap;
    mask (B, H, W, 9), already sigmoided, or None (weight 1); weight OIHW
    (Cout, Cin, 3, 3); bias (Cout,) or None; `packed` is
    `pack_dcn(weight, bias)` made ahead of time, or None to pack on this
    call. Returns (B, H, W, Cout). On the card a (C, R) pair whose shared
    memory exceeds the per-block limit raises ValueError."""
    del tile_w  # TPU tiling knob: no effect on the function
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not OIHW 3x3 "
                         f"with cin={cin}")
    cout = weight.shape[0]
    if tuple(offset.shape) != (b, h, w, 18) or (
            mask is not None and tuple(mask.shape) != (b, h, w, 9)):
        raise ValueError(f"offset {tuple(offset.shape)} / mask "
                         f"{None if mask is None else tuple(mask.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return deform_conv2d_bounded_plain(x, offset, mask, weight, bias,
                                           max_offset)
    dev = _cuda_checks("deform_conv2d_bounded", x=x, offset=offset, mask=mask)
    if not 1 <= cout <= DCN_MAX_COUT or max_offset < 0:
        raise ValueError(f"deform_conv2d_bounded kernel takes Cout in "
                         f"1..{DCN_MAX_COUT} and R >= 0, got Cout={cout}, "
                         f"R={max_offset}")
    if weight.device != dev or (bias is not None and bias.device != dev):
        raise ValueError("weight and bias must be on the input's device")
    lib = build.load()
    smem = lib.vfi_dcn_bounded_smem_bytes(cin, cout, int(max_offset))
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"deform_conv2d_bounded kernel: C={cin}->{cout} at R="
            f"{max_offset} needs {smem} bytes of shared memory per block, "
            f"above the card's limit of {limit} bytes ({limit // 1024} KB)")

    wpk, bpk = packed or pack_dcn(weight, bias)
    if (tuple(wpk.shape) != (9 * _pad16(cin), _pad16(cout))
            or wpk.device != dev):
        raise ValueError("packed weights do not match this DCN's channels "
                         "or device")
    out = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device=dev)
    xp = pad_channels8(x)
    rc = lib.vfi_dcn_bounded_bf16(
        xp.data_ptr(), offset.data_ptr(),
        None if mask is None else mask.data_ptr(), wpk.data_ptr(),
        bpk.data_ptr(), out.data_ptr(), b, h, w, xp.shape[-1], cout,
        int(max_offset), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "deform_conv2d_bounded")
    deform_conv2d_bounded.launches += 1
    deform_conv2d_bounded.launches_by_shape[
        (cin, cout, h, w, int(max_offset))] += 1
    return out


def bounded_warp(image: torch.Tensor, flow: torch.Tensor,
                 max_flow: int = 16) -> torch.Tensor:
    """image (B, H, W, C); flow (B, H, W, 2) channels (dx, dy) in pixels,
    clipped to [-max_flow, max_flow]. Bilinear, zeros padding."""
    if image.dim() != 4 or tuple(flow.shape) != tuple(image.shape[:3]) + (2,):
        raise ValueError(f"image {tuple(image.shape)} / flow "
                         f"{tuple(flow.shape)} shapes do not match")
    if image.device.type == "cpu":
        return bounded_warp_plain(image, flow, max_flow)
    dev = _cuda_checks("bounded_warp", image=image, flow=flow)
    b, h, w, c = image.shape
    if c > 4:
        raise ValueError(f"bounded_warp kernel takes C <= 4, got {c}")
    out = torch.empty_like(image)
    lib = build.load()
    rc = lib.vfi_warp_bounded_bf16(
        image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c,
        float(max_flow), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "bounded_warp")
    bounded_warp.launches += 1
    bounded_warp.launches_by_shape[(c, h, w)] += 1
    return out


deform_conv2d_bounded.launches = 0
deform_conv2d_bounded.launches_by_shape = Counter()
bounded_warp.launches = 0
bounded_warp.launches_by_shape = Counter()
