"""Bounded sampling kernels: the CUDA kernels `csrc/dcn_bounded.cu` and
`csrc/warp_bounded.cu`, with their plain PyTorch versions.

- `deform_conv2d_bounded` replaces
  `vfi_tpu/ops/pallas/sampling.py::deform_conv2d_pallas_v4` (kernel
  `_sampling_kernel_v4`), `deform_conv2d_pallas_v5` (`_sampling_kernel_v5`)
  and `deform_conv2d_pallas` (v3, `_sampling_kernel`), which compute one
  function: modulated DCNv2, stride 1, 3x3, padding 1, one offset group,
  offsets clamped to [-R, R], any Cin, Cout up to 128, an optional mask
  (None: weight 1) and an optional bias. Any R whose smallest tile plan
  fits the card's shared memory (on an H100 R <= 35 at any Cout;
  `dcn_plan`). Plain version:
  `ops/deform_conv_shifts.deform_conv2d_shifts`.
- `bounded_warp` replaces `bounded_warp_pallas_v2` (kernel
  `_warp_kernel_v2`, C <= 4) and `bounded_warp_pallas` (v1, `_warp_kernel`,
  any C): backward warp by the flow clipped to [-R, R]. Plain version:
  `ops/warp.warp(image, clip(flow))`, blended in the image's dtype for
  C <= 4 (as v2 and the RGB kernel) and in float32 with one rounding
  above (as v1's float32 tile and the wide kernel).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(bf16, contiguous) or raises. On the card the result carries autograd
when an input requires grad: autograd of the plain version (`grad.py`), as
the reference's `deform_conv2d_fast` and `warp_fast`. `tile_w` is accepted
for API parity with the JAX wrappers (a TPU skip-predicate tiling knob)
and has no effect on the output.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from vfi_tpu_torch.ops.cuda import build
from vfi_tpu_torch.ops.cuda.conv import _pad16, pack_conv2d, pad_channels8
from vfi_tpu_torch.ops.cuda.grad import differentiable
from vfi_tpu_torch.ops.deform_conv_shifts import deform_conv2d_shifts
from vfi_tpu_torch.ops.warp import warp

DCN_MAX_COUT = 128
# The RGB warp instance's channels; wider images blend in float32.
WARP_RGB_MAX_C = 4
# The DCN kernel's tap pattern: 3x3 with padding 1, the only one any caller
# in the repo passes.
DCN_K, DCN_PADDING = 3, 1
# The DCN kernel reads `pack_conv2d`'s tap-major layout.
pack_dcn = pack_conv2d


def deform_conv2d_bounded_plain(x, offset, mask, weight, bias=None,
                                max_offset: int = 3,
                                packed: Optional[tuple] = None,
                                padding: int = DCN_PADDING) -> torch.Tensor:
    """Reads `weight` and `bias`; `packed`, the kernel's copy of them, is
    taken only so that this function and `deform_conv2d_bounded` share one
    signature."""
    return deform_conv2d_shifts(x, offset, mask, weight, bias,
                                max_offset=max_offset, padding=padding)


def bounded_warp_plain(image: torch.Tensor, flow: torch.Tensor,
                       max_flow: int = 16) -> torch.Tensor:
    r = float(max_flow)
    if image.shape[-1] <= WARP_RGB_MAX_C:
        return warp(image, flow.clamp(-r, r))
    return warp(image.float(), flow.clamp(-r, r)).to(image.dtype)


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


def dcn_plan(cin: int, cout: int, max_offset: int,
             device: torch.device) -> dict:
    """The DCN kernel's tile plan on `device` (`csrc/dcn_bounded.cu`):
    pixels per block, tile channels per chunk, chunks, and its dynamic
    shared memory in bytes. Raises ValueError where no plan fits the
    card's per-block limit."""
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    px_ck = (ctypes.c_int * 2)()
    smem = build.load().vfi_dcn_bounded_smem_bytes(
        _pad16(cin), cout, int(max_offset), limit, px_ck)
    if smem == 0:
        raise ValueError(
            f"deform_conv2d_bounded kernel: no tile plan for C={cin}->{cout} "
            f"at R={max_offset} fits the card's {limit} bytes of shared "
            f"memory per block (the smallest plan, 16 pixels and 16 "
            f"channels a chunk, holds (3 + 2R)(18 + 2R) * 32 bytes of "
            f"tile; on an H100 R <= 35 at any Cout)")
    return {"px": px_ck[0], "ck": px_ck[1],
            "chunks": -(-_pad16(cin) // px_ck[1]), "smem_bytes": smem}


def deform_conv2d_bounded(x: torch.Tensor, offset: torch.Tensor,
                          mask: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          max_offset: int = 3,
                          tile_w: Optional[int] = None,
                          packed: Optional[tuple] = None,
                          padding: int = DCN_PADDING) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC; offset (B, H, W, 18) as (dy, dx) per tap;
    mask (B, H, W, 9), already sigmoided, or None (weight 1); weight OIHW
    (Cout, Cin, 3, 3); bias (Cout,) or None; `packed` is
    `pack_dcn(weight, bias)` made ahead of time, or None to pack on this
    call; `padding` 1 (v3's argument; the only value the kernel takes).
    Returns (B, H, W, Cout)."""
    del tile_w  # TPU tiling knob: no effect on the function
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if (weight.dim() != 4 or tuple(weight.shape[1:]) != (cin, DCN_K, DCN_K)
            or padding != DCN_PADDING):
        raise ValueError(f"deform_conv2d_bounded takes a 3x3 OIHW weight "
                         f"with cin={cin} and padding 1, got weight "
                         f"{tuple(weight.shape)}, padding {padding}")
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
    dcn_plan(cin, cout, max_offset, dev)   # raises where no plan fits
    wpk, bpk = packed or pack_dcn(weight, bias)
    if (tuple(wpk.shape) != (9 * _pad16(cin), _pad16(cout))
            or wpk.device != dev):
        raise ValueError("packed weights do not match this DCN's channels "
                         "or device")
    R = int(max_offset)

    def launch(x, offset, mask, *_):
        out = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device=dev)
        xp = pad_channels8(x)
        rc = build.load().vfi_dcn_bounded_bf16(
            xp.data_ptr(), offset.data_ptr(),
            None if mask is None else mask.data_ptr(), wpk.data_ptr(),
            bpk.data_ptr(), out.data_ptr(), b, h, w, xp.shape[-1], cout, R,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "deform_conv2d_bounded")
        deform_conv2d_bounded.launches += 1
        deform_conv2d_bounded.launches_by_shape[(cin, cout, h, w, R)] += 1
        return out

    def plain(x, offset, mask, weight, bias):
        return deform_conv2d_bounded_plain(x, offset, mask, weight, bias, R)

    return differentiable(launch, plain, x, offset, mask, weight, bias)


def bounded_warp(image: torch.Tensor, flow: torch.Tensor,
                 max_flow: int = 16) -> torch.Tensor:
    """image (B, H, W, C), any C; flow (B, H, W, 2) channels (dx, dy) in
    pixels, clipped to [-max_flow, max_flow]. Bilinear, zeros padding."""
    if image.dim() != 4 or tuple(flow.shape) != tuple(image.shape[:3]) + (2,):
        raise ValueError(f"image {tuple(image.shape)} / flow "
                         f"{tuple(flow.shape)} shapes do not match")
    if image.device.type == "cpu":
        return bounded_warp_plain(image, flow, max_flow)
    dev = _cuda_checks("bounded_warp", image=image, flow=flow)
    b, h, w, c = image.shape

    def launch(image, flow):
        out = torch.empty_like(image)
        rc = build.load().vfi_warp_bounded_bf16(
            image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c,
            float(max_flow), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "bounded_warp")
        bounded_warp.launches += 1
        bounded_warp.launches_by_shape[(c, h, w, int(max_flow))] += 1
        return out

    def plain(image, flow):
        return bounded_warp_plain(image, flow, max_flow)

    return differentiable(launch, plain, image, flow)


deform_conv2d_bounded.launches = 0
deform_conv2d_bounded.launches_by_shape = Counter()
bounded_warp.launches = 0
bounded_warp.launches_by_shape = Counter()
