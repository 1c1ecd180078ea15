"""Bounded sampling kernels: the CUDA kernels `csrc/dcn_bounded.cu` and
`csrc/warp_bounded.cu`, with their plain PyTorch versions.

- `deform_conv2d_bounded` replaces
  `vfi_tpu/ops/pallas/sampling.py::deform_conv2d_pallas_v4` (kernel
  `_sampling_kernel_v4`), `deform_conv2d_pallas_v5` (`_sampling_kernel_v5`)
  and `deform_conv2d_pallas` (v3, `_sampling_kernel`), which compute one
  function: modulated DCNv2, stride 1, 3x3, padding 1, one offset group,
  offsets clamped to [-R, R], any Cin, Cout up to 128, an optional mask
  (None: weight 1) and an optional bias. Any R for which a plan fits the
  card's shared memory (on an H100 R <= 35 at any Cout; `dcn_plan`, pure
  Python, picks the kernel's design and tiles). Plain version:
  `ops/deform_conv_shifts.deform_conv2d_shifts`.
- `bounded_warp` replaces `bounded_warp_pallas_v2` (kernel
  `_warp_kernel_v2`, C <= 4) and `bounded_warp_pallas` (v1, `_warp_kernel`,
  any C): backward warp by the flow clipped to [-R, R]. Plain version:
  `ops/warp.warp(image, clip(flow))`, blended in the image's dtype for
  C <= 4 (as v2 and the RGB kernel) and in float32 with one rounding
  above (as v1's float32 tile and the wide kernel).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(bf16 or float32, every operand of one dtype, contiguous; the float32
instances sample and blend in the plain version's float32 arithmetic, the
DCN's GEMM in 3xTF32 on the tensor cores) or raises. The DCN's input `x`
may also be a view or two parts split along channels, which its bf16
designs read in place (`ops/cuda/conv.py` "Inputs"), and it counts its
launches by how it took `x` in `launches_by_input`. Asked to
(`padded=True`, by a caller that hands the result to a kernel that reads
views) and on the path where the kernels read in place (`reads_views`),
a DCN whose Cout is not a multiple of 8 writes Cout padded to 8 (the
padding channels zeros) and returns the [..., :Cout] view, and the RGB
warp (C <= 4) writes 8 channels a pixel (C values, then zeros) and
returns the [..., :C] view: a kernel reads either as (part of) its input
where the tensor itself (134- or 6-byte pixels) would need a padded copy.
Packed DCN weights are made in the input's dtype (`pack_dcn(..., dtype=)`);
another dtype raises ValueError. Every launch key in `launches_by_shape`
ends with the instance's tag, "bf16" or "f32". On the card the result
carries autograd when an input requires grad: autograd of the plain
version (`grad.py`, in the inputs' own dtype), as
the reference's `deform_conv2d_fast` and `warp_fast`; without grad the
launch builds no closure. Inside `hand_backward()` the DCN's backward
is the hand-written `deform_conv2d_shifts_bwd` on the saved inputs
instead, with no recomputed forward, on either device (the ablation of
the JAX package's `tools/bench_train_step.py`). A launch calls its C
entry bound once (`build.entry`) on PyTorch's raw current stream.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter
from typing import Optional

import torch

from vfi_tpu_torch.ops.cuda import build
from vfi_tpu_torch.ops.cuda.conv import (F32_FLUSH_K, H100_SMEM_PER_BLOCK,
                                         KERNEL_DTYPES, ROW_PAD, _pad8,
                                         _pad16, _round128, _smem_limit,
                                         as_parts, cat_parts, kernel_input,
                                         pack_conv2d, packed_shape,
                                         parts_args, reads_views)
from vfi_tpu_torch.ops.cuda.grad import ThroughPlain, needs_grad
from vfi_tpu_torch.ops.deform_conv_shifts import (deform_conv2d_shifts,
                                                  deform_conv2d_shifts_bwd)
from vfi_tpu_torch.ops.warp import warp

DCN_MAX_COUT = 128
# The RGB warp instance's channels; wider images blend in float32.
WARP_RGB_MAX_C = 4
# The DCN kernel's tap pattern: 3x3 with padding 1, the only one any caller
# in the repo passes.
DCN_K, DCN_PADDING = 3, 1
# The DCN kernel reads `pack_conv2d`'s tap-major layout.
pack_dcn = pack_conv2d
# The DCN kernel's tile design: output tiles of rows x DCN_TILE_W pixels
# with two or one input buffers, in the order the plan tries them. Within
# an H100's shared memory, 8 x 16 tiles with two buffers fit no shape that
# 16 x 16 with one does not (tests/test_torch_dcn_plan.py), so they are
# not tried. Its stream design: the tile rows it tries, in order (on an
# H100 8 x 16 beat 16 x 16 by 3-9% at every shape measured:
# csrc/dcn_bounded.cu).
DCN_TILE_PLANS, DCN_TILE_W = ((16, 2), (16, 1), (8, 1)), 16
DCN_STREAM_ROWS = (8, 4)
# The float32 instances (3xTF32 on the tensor cores): the tile design on
# 8 x 16 tiles with one input buffer (16 x 16, 16 warps of at most 128
# registers, would spill past Cout16 = 16 with its flushed sums); the
# stream design on 8 x 16, then 4 x 16 tiles, in chunks of multiples of 8
# channels (one k-step); slab and weight rows padded by DCN_F32_ROW_PAD
# floats (F_PAD in csrc/dcn_bounded.cu). Both flush their sums into float32
# registers every tap (tile) or step (stream), so the plan keeps the tile
# design's Cin8 and the stream design's chunk within F32_FLUSH_K.
DCN_TILE_ROWS_F32 = 8
DCN_STREAM_ROWS_F32 = (8, 4)
DCN_F32_ROW_PAD = 4


def deform_conv2d_bounded_plain(x, offset, mask, weight, bias=None,
                                max_offset: int = 3,
                                packed: Optional[tuple] = None,
                                padding: int = DCN_PADDING,
                                padded: bool = False) -> torch.Tensor:
    """`x` a tensor or its parts (`cat_parts`). Reads `weight` and `bias`;
    `packed`, the kernel's copy of them, and `padded` are taken only so
    that this function and `deform_conv2d_bounded` share one signature."""
    return deform_conv2d_shifts(cat_parts(x), offset, mask, weight, bias,
                                max_offset=max_offset, padding=padding)


class HandBackward(torch.autograd.Function):
    """forward: `launch(x, offset, mask)`; backward: the hand-written
    `deform_conv2d_shifts_bwd` on the saved inputs at radius R."""

    @staticmethod
    def forward(ctx, launch, R, x, offset, mask, weight, bias):
        ctx.R = R
        ctx.save_for_backward(x, offset, mask, weight, bias)
        return launch(x, offset, mask)

    @staticmethod
    def backward(ctx, g):
        grads = deform_conv2d_shifts_bwd(*ctx.saved_tensors, g.contiguous(),
                                         max_offset=ctx.R)
        return (None, None, *(d if n else None for d, n in
                              zip(grads, ctx.needs_input_grad[2:])))


# Whether the DCN records `HandBackward` (inside `hand_backward()`) or
# `ThroughPlain` when its inputs need grad; read at the forward.
_HAND_BACKWARD = [False]


@contextlib.contextmanager
def hand_backward():
    """Within the block, a bounded DCN whose inputs need grad records the
    hand-written backward (`HandBackward`) instead of autograd of the plain
    version; on exit the previous choice returns. The counterpart of the
    `defvjp` swap in the JAX package's `tools/bench_train_step.py`: for
    ablations, not for training."""
    prev = _HAND_BACKWARD[0]
    _HAND_BACKWARD[0] = True
    try:
        yield
    finally:
        _HAND_BACKWARD[0] = prev


def bounded_warp_plain(image: torch.Tensor, flow: torch.Tensor,
                       max_flow: int = 16, padded: bool = False
                       ) -> torch.Tensor:
    """`padded` is taken only so that this function and `bounded_warp`
    share one signature."""
    r = float(max_flow)
    if image.shape[-1] <= WARP_RGB_MAX_C:
        return warp(image, flow.clamp(-r, r))
    return warp(image.float(), flow.clamp(-r, r)).to(image.dtype)


def _cuda_checks(name: str, strided: tuple = (), **tensors) -> int:
    """The index of the card the tensors lie on; raises unless each is a
    CUDA tensor on one card, contiguous unless named in `strided`, all of
    one dtype the kernels take (bfloat16 or float32; None entries are
    skipped)."""
    dev = dtype = None
    for k, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {k} on {t.device}, expected cuda")
        if t.dtype not in KERNEL_DTYPES:
            raise TypeError(f"{name} kernel takes bfloat16 or float32 {k}, "
                            f"got {t.dtype}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} kernel takes operands of one dtype, got "
                            f"{k} {t.dtype} beside {dtype}")
        dtype = t.dtype
        if k not in strided and not t.is_contiguous():
            raise ValueError(f"{name} kernel takes a contiguous {k}")
        d = t.get_device()
        if dev is not None and d != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = d
    return dev


def _dcn_xu(cin8: int, itemsize: int = 2) -> int:
    """The tile design's input-tile pixel stride in 16-byte units: the
    pixel's 16-byte pieces (cin8 / 8 in bf16, cin8 / 4 in float32), plus
    one where that count is even, so that 16-byte reads of neighbouring
    pixels fall in distinct banks (`dcn_xu` in csrc/dcn_bounded.cu)."""
    pieces = cin8 * itemsize // 16
    return pieces + (pieces % 2 == 0)


def _slab_bytes(rows: int, chans: int, itemsize: int = 2) -> int:
    """A block's sample slabs: one a warp of 16 pixels x `chans`
    channels, pixel-major, rows padded by ROW_PAD bf16 or DCN_F32_ROW_PAD
    floats."""
    pad = ROW_PAD if itemsize == 2 else DCN_F32_ROW_PAD
    return rows * DCN_TILE_W * (chans + pad) * itemsize


def _slice_bytes(cout16: int, chans: int, itemsize: int = 2) -> int:
    """One streamed weight slice of `chans` input channels: bf16
    [chans][Cout16 + 8], float32 [Cout16][chans + 4] (K contiguous)."""
    if itemsize == 2:
        return chans * (cout16 + ROW_PAD) * 2
    return cout16 * (chans + DCN_F32_ROW_PAD) * 4


def _dcn_chunks(cin: int, unit: int = 16) -> list:
    """The stream design's chunk widths, widest first: `cin` (a multiple
    of `unit`) split into n = 1, 2, ... chunks of one multiple of `unit`
    (the last may be narrower)."""
    widths = set()
    for n in range(1, cin // unit + 1):
        per = -(-cin // n)
        widths.add(-(-per // unit) * unit)
    return sorted(widths, reverse=True)


def _stream_plan(cin: int, cout: int, R: int, limit: int,
                 itemsize: int = 2) -> Optional[dict]:
    """The stream design's plan (`csrc/dcn_bounded.cu`), or None where no
    tile holds its narrowest chunk: output tiles of `rows` x 16 pixels
    (`DCN_STREAM_ROWS`; in float32 `DCN_STREAM_ROWS_F32`), two weight
    slices of `chans` channels (`_slice_bytes`), one input-tile buffer of
    (rows + 2 + 2R) x (18 + 2R) pixels x `xu` 16-byte units, and one slab a
    warp of 16 pixels x `chans` channels (`_slab_bytes`). Chunks: Cin16
    split into equal multiples of 16 (bf16), Cin8 into equal multiples of 8
    (float32; `_dcn_chunks`, at most F32_FLUSH_K channels: a step's sums
    are flushed). It takes the larger tile, then the widest chunk, with the
    odd pixel stride of the tile design (`_dcn_xu` of the chunk's pieces)
    and, where none fits, with the pieces unpadded."""
    cin8, cout16 = _pad8(cin), _pad16(cout)
    per = 16 // itemsize                       # channels a 16-byte piece
    width = _pad16(cin) if itemsize == 2 else cin8
    chunks = _dcn_chunks(width, 16 if itemsize == 2 else 8)
    if itemsize == 4:
        chunks = [c for c in chunks if c <= F32_FLUSH_K]
    for padded in (True, False):
        for rows in (DCN_STREAM_ROWS if itemsize == 2
                     else DCN_STREAM_ROWS_F32):
            tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
            for chans in chunks:
                pieces = min(chans, cin8) // per
                xu = _dcn_xu(pieces * per, itemsize) if padded else pieces
                x_bytes = _round128(tpx * xu * 16)
                w_bytes = 2 * _slice_bytes(cout16, chans, itemsize)
                s_bytes = _slab_bytes(rows, chans, itemsize)
                smem = w_bytes + x_bytes + s_bytes
                if smem <= limit:
                    plan = {"design": "stream",
                            "tile": f"{rows}x{DCN_TILE_W}", "rows": rows,
                            "nbuf": 1, "chans": chans,
                            "chunks": -(-width // chans), "xu": xu,
                            "x_bytes": x_bytes, "w_bytes": w_bytes,
                            "s_bytes": s_bytes, "smem_bytes": smem}
                    return plan if itemsize == 2 else {**plan,
                                                       "core": "tf32x3"}
    return None


def _tile_plan_f32(cin: int, cout: int, R: int, limit: int
                   ) -> Optional[dict]:
    """The float32 tile design's plan (tensor cores), or None: the weights
    [Cout16][9 * Cin8 + 4] floats resident, one input buffer, one slab a
    warp of 16 pixels x (`chans` + 4) floats, on 8 x 16 tiles with the
    widest slab (a multiple of 8 channels up to Cin8) that fits. None past
    Cin8 = F32_FLUSH_K: the kernel flushes its sums once a tap."""
    cin8, cout16 = _pad8(cin), _pad16(cout)
    if cin8 > F32_FLUSH_K:
        return None
    rows, xu = DCN_TILE_ROWS_F32, _dcn_xu(cin8, 4)
    w_bytes = 4 * cout16 * (9 * cin8 + DCN_F32_ROW_PAD)
    tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
    x_bytes = _round128(tpx * xu * 16)
    free = limit - w_bytes - x_bytes
    for chans in range(cin8, 0, -8):
        s_bytes = _slab_bytes(rows, chans, 4)
        if s_bytes <= free:
            return {"design": "tile", "core": "tf32x3",
                    "tile": f"{rows}x{DCN_TILE_W}", "rows": rows,
                    "nbuf": 1, "chans": chans,
                    "passes": -(-cin8 // chans), "xu": xu,
                    "x_bytes": x_bytes, "w_bytes": w_bytes,
                    "s_bytes": s_bytes,
                    "smem_bytes": w_bytes + x_bytes + s_bytes}
    return None


@functools.lru_cache(maxsize=None)
def dcn_plan(cin: int, cout: int, max_offset: int,
             limit: int = H100_SMEM_PER_BLOCK, itemsize: int = 2) -> dict:
    """The DCN kernel's plan (`csrc/dcn_bounded.cu`) for Cin -> Cout at
    radius R within `limit` bytes of shared memory per block, for its
    bf16 instances (`itemsize` 2) or its float32 ones (4).

    Design "tile" (weight-stationary, persistent): the packed weights
    [9 * Cin16][Cout16 + 8] resident, `nbuf` input-tile buffers of
    (rows + 2 + 2R) x (18 + 2R) pixels, and one sample slab a warp of
    2 * rows pixels x (chans + 8) channels. It takes the first that fits of
    16 x 16 output tiles with two buffers, with one, then 8 x 16 tiles with
    one, each with the widest slab (a multiple of 16 channels up to Cin16)
    that fits.
    Where none fits (the resident weights and one buffer too large), design
    "stream" (`_stream_plan`): 8 x 16 or 4 x 16 tiles on the same GEMM core
    with the weights streamed a (chunk, tap) slice at a time and the input
    in channel chunks. On an H100 the tile design holds C = 64
    up to R = 8 and C = 67 up to R = 6; the stream design runs C = 64 from
    R = 9, C = 67 from R = 7 and C = 128 at every R.
    Float32 (`_tile_plan_f32`, then `_stream_plan`): the same designs on
    3xTF32 (plan key "core": "tf32x3"), the weights packed [Cout16][9 *
    Cin8] (K contiguous), slabs of multiples of 8 channels, sums flushed
    into float32 registers every tap (tile) or step (stream); the tile
    design with one input buffer on 8 x 16 tiles up to Cin8 = F32_FLUSH_K,
    its warps in pairs; the stream design on 8 x 16, then 4 x 16, its
    chunks at most F32_FLUSH_K channels. On an H100 C = 64 runs
    the tile design up to R = 1 (on 8 x 16 tiles with 32-channel slab
    passes), C = 67 and C = 128 the stream design at every R; R <= 35 fits
    at any Cin <= 128 and Cout <= 128, as in bf16 (R = 35 on 4 x 16 tiles
    in 8-channel chunks; `tests/test_torch_f32.py`). The FFMA designs they
    replaced were slower at every float32 shape a path runs (device ms per
    launch, FFMA / 3xTF32, medians of two turns each of
    `tools/conv_turns.py` on an H100 at 700 W): C = 64, R = 1 at 720p 2.988
    / 1.785 (the stream design there: 2.031), 4x480x640 3.959 / 2.375,
    2x320x320 0.724 / 0.442; at 480x640 C = 67, R = 2 1.522 / 1.095, R = 8
    1.788 / 1.280, C = 128, R = 4 3.249 / 2.235.
    Raises ValueError past Cout 128 or R < 0, or where nothing fits (on an
    H100 R <= 35 fits at any Cin <= 128 and Cout <= 128)."""
    R = int(max_offset)
    if not 1 <= cout <= DCN_MAX_COUT or R < 0 or cin < 1:
        raise ValueError(f"deform_conv2d_bounded kernel takes Cout in "
                         f"1..{DCN_MAX_COUT} and R >= 0, got Cin={cin}, "
                         f"Cout={cout}, R={max_offset}")
    if itemsize not in (2, 4):
        raise ValueError(f"deform_conv2d_bounded kernel has bf16 and float32 "
                         f"instances, got itemsize {itemsize}")
    cin8 = _pad8(cin)
    cin16, cout16 = _pad16(cin), _pad16(cout)
    xu = _dcn_xu(cin8, itemsize)
    w_bytes = 9 * cin16 * (cout16 + ROW_PAD) * 2
    plan = _tile_plan_f32(cin, cout, R, limit) if itemsize == 4 else None
    for rows, nbuf in (DCN_TILE_PLANS if itemsize == 2 else ()):
        tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
        x_bytes = _round128(tpx * xu * 16)
        free = limit - w_bytes - nbuf * x_bytes
        for chans in range(cin16, 0, -16):
            s_bytes = _slab_bytes(rows, chans)
            if s_bytes <= free:
                return {"design": "tile",
                        "tile": f"{rows}x{DCN_TILE_W}", "rows": rows,
                        "nbuf": nbuf, "chans": chans,
                        "passes": -(-cin16 // chans), "xu": xu,
                        "x_bytes": x_bytes, "w_bytes": w_bytes,
                        "s_bytes": s_bytes,
                        "smem_bytes": w_bytes + nbuf * x_bytes + s_bytes}
    if plan is None:
        plan = _stream_plan(cin, cout, R, limit, itemsize)
    if plan is None:
        raise ValueError(
            f"deform_conv2d_bounded kernel: no plan for C={cin}->{cout} at "
            f"R={max_offset} fits {limit} bytes of shared memory per block "
            f"(the smallest, a 4 x 16 tile and 16 channels a chunk, holds "
            f"(6 + 2R)(18 + 2R) * 32 bytes of input; on an H100 R <= 35 at "
            f"any Cout)")
    return plan


def _dcn_launch(xp, form, offset, mask, wpk, bpk, cin, cout, R, plan, dev,
                pad_out=False):
    """One launch on `plan` of the Cin-channel input's parts `xp` as
    `kernel_input` gives them (taken as `form`); with `pad_out` (bf16)
    into Cout padded to 8, returning the [..., :Cout] view."""
    x0 = xp[0]
    b, h, w, _ = x0.shape
    tag = KERNEL_DTYPES[x0.dtype]
    oc = _pad8(cout) if pad_out else cout
    out = torch.empty(b, h, w, oc, dtype=x0.dtype, device=x0.device)
    if offset.data_ptr() % (2 * offset.element_size()):
        offset = offset.clone()   # the kernel reads (dy, dx) as one word
    meta = (offset.data_ptr(), None if mask is None else mask.data_ptr(),
            wpk.data_ptr(), bpk.data_ptr(), out.data_ptr())
    design = 0 if plan["design"] == "tile" else 1
    tail = (plan["xu"], plan["x_bytes"], plan["smem_bytes"], dev,
            build.current_stream(dev))
    if tag == "f32":
        rc = build.entry("vfi_dcn_bounded_f32")(
            x0.data_ptr(), *meta, b, h, w, x0.shape[-1], cout, R, design,
            plan["rows"], plan["chans"], *tail)
    else:
        rc = build.entry("vfi_dcn_bounded_bf16")(
            *parts_args(xp), *meta, oc, b, h, w, cout, R, design,
            plan["rows"], plan["chans"], plan["nbuf"], *tail)
    if rc:
        build.check(rc, "deform_conv2d_bounded")
    deform_conv2d_bounded.launches += 1
    deform_conv2d_bounded.launches_by_shape[(cin, cout, h, w, R, tag)] += 1
    deform_conv2d_bounded.launches_by_input[(form, tag)] += 1
    return out if oc == cout else out[..., :cout]


def deform_conv2d_bounded(x, offset: torch.Tensor,
                          mask: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          max_offset: int = 3,
                          packed: Optional[tuple] = None,
                          padding: int = DCN_PADDING,
                          padded: bool = False) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC, or its two parts split along channels
    (`ops/cuda/conv.py` "Inputs"); offset (B, H, W, 18) as (dy, dx) per tap;
    mask (B, H, W, 9), already sigmoided, or None (weight 1); weight OIHW
    (Cout, Cin, 3, 3); bias (Cout,) or None; `packed` is
    `pack_dcn(weight, bias)` made ahead of time, or None to pack on this
    call; `padding` 1 (v3's argument; the only value the kernel takes);
    `padded`: the result goes to a kernel that reads views (the module
    docstring). Returns (B, H, W, Cout)."""
    parts = as_parts(x)
    x0 = parts[0]
    (b, h, w, _), cin = x0.shape, sum(p.shape[3] for p in parts)
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
    R = int(max_offset)
    grad = needs_grad(*parts, offset, mask, weight, bias)
    hand = _HAND_BACKWARD[0] and grad
    if grad:   # autograd saves one input tensor: the parts' concatenation
        x = cat_parts(parts)
    if x0.device.type == "cpu":
        if hand:
            return HandBackward.apply(
                lambda x, offset, mask: deform_conv2d_bounded_plain(
                    x, offset, mask, weight, bias, R),
                R, x, offset, mask, weight, bias)
        return deform_conv2d_bounded_plain(x, offset, mask, weight, bias,
                                           max_offset)
    dev = _cuda_checks("deform_conv2d_bounded", ("x", "x1"),
                       **dict(zip(("x", "x1"), parts)), offset=offset,
                       mask=mask)
    if not 1 <= cout <= DCN_MAX_COUT or max_offset < 0:
        raise ValueError(f"deform_conv2d_bounded kernel takes Cout in "
                         f"1..{DCN_MAX_COUT} and R >= 0, got Cout={cout}, "
                         f"R={max_offset}")
    if weight.get_device() != dev or (bias is not None
                                      and bias.get_device() != dev):
        raise ValueError("weight and bias must be on the input's device")
    # raises where none fits
    plan = dcn_plan(cin, cout, R, _smem_limit(dev), x0.element_size())
    wpk, bpk = packed or pack_dcn(weight, bias, x0.dtype)
    if (tuple(wpk.shape) != packed_shape(cin, cout, DCN_K, x0.dtype)
            or wpk.get_device() != dev or wpk.dtype != x0.dtype):
        raise ValueError("packed weights do not match this DCN's channels, "
                         "device or dtype")
    bf16 = x0.dtype == torch.bfloat16
    xp, form = kernel_input(x, "deform_conv2d_bounded", bf16)
    if grad and len(parts) == 2:
        form = "copied"
    if hand:
        return HandBackward.apply(
            lambda x, offset, mask: _dcn_launch(xp, form, offset, mask, wpk,
                                                bpk, cin, cout, R, plan, dev),
            R, x, offset, mask, weight, bias)
    if not grad:
        return _dcn_launch(xp, form, offset, mask, wpk, bpk, cin, cout, R,
                           plan, dev, pad_out=padded and cout % 8 != 0
                           and reads_views(x0, *parts[1:], offset, mask,
                                           weight, bias))
    return ThroughPlain.apply(
        lambda x, offset, mask, *_: _dcn_launch(xp, form, offset, mask, wpk,
                                                bpk, cin, cout, R, plan, dev),
        lambda x, offset, mask, weight, bias: deform_conv2d_bounded_plain(
            x, offset, mask, weight, bias, R),
        x, offset, mask, weight, bias)


# The warp's C entry of each dtype.
_WARP_ENTRIES = {torch.bfloat16: "vfi_warp_bounded_bf16",
                 torch.float32: "vfi_warp_bounded_f32"}


def _warp_launch(image, flow, max_flow, dev, pad_out=False):
    """One launch; with `pad_out` (bf16, C <= 4) into 8 channels a pixel,
    returning the [..., :C] view."""
    b, h, w, c = image.shape
    oc = 8 if pad_out else c
    out = (torch.empty(b, h, w, oc, dtype=image.dtype, device=image.device)
           if pad_out else torch.empty_like(image))
    rc = build.entry(_WARP_ENTRIES[image.dtype])(
        image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c, oc,
        float(max_flow), dev, build.current_stream(dev))
    if rc:
        build.check(rc, "bounded_warp")
    bounded_warp.launches += 1
    bounded_warp.launches_by_shape[
        (c, h, w, int(max_flow), KERNEL_DTYPES[image.dtype])] += 1
    return out[..., :c] if pad_out else out


def bounded_warp(image: torch.Tensor, flow: torch.Tensor,
                 max_flow: int = 16, padded: bool = False) -> torch.Tensor:
    """image (B, H, W, C), any C; flow (B, H, W, 2) channels (dx, dy) in
    pixels, clipped to [-max_flow, max_flow]. Bilinear, zeros padding.
    `padded`: the result goes to a kernel that reads views (the module
    docstring)."""
    if image.dim() != 4 or flow.shape != (*image.shape[:3], 2):
        raise ValueError(f"image {tuple(image.shape)} / flow "
                         f"{tuple(flow.shape)} shapes do not match")
    if not image.is_cuda and image.device.type == "cpu":
        return bounded_warp_plain(image, flow, max_flow, padded)
    dev = image.get_device()
    if not (flow.get_device() == dev >= 0 and image.dtype is flow.dtype
            and image.dtype in _WARP_ENTRIES and image.is_contiguous()
            and flow.is_contiguous()):   # the common case in one test
        dev = _cuda_checks("bounded_warp", image=image, flow=flow)
    if not (torch.is_grad_enabled()
            and (image.requires_grad or flow.requires_grad)):
        return _warp_launch(image, flow, max_flow, dev,
                            padded and image.shape[-1] <= WARP_RGB_MAX_C
                            and reads_views(image))
    return ThroughPlain.apply(
        lambda image, flow: _warp_launch(image, flow, max_flow, dev),
        lambda image, flow: bounded_warp_plain(image, flow, max_flow),
        image, flow)


deform_conv2d_bounded.launches = 0
deform_conv2d_bounded.launches_by_shape = Counter()
# Launches by (form, dtype tag): how each took its input (INPUT_FORMS).
deform_conv2d_bounded.launches_by_input = Counter()
bounded_warp.launches = 0
bounded_warp.launches_by_shape = Counter()
