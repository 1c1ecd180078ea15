"""Convolution kernels: the fused stride-1 3x3 chain (`csrc/conv_chain.cu`)
and the single stride-1 odd-k conv (`csrc/conv2d.cu`), with their plain
PyTorch versions.

- `conv_chain` replaces `vfi_tpu/ops/pallas/conv.py::conv_chain_pallas`
  (kernel `_chain_kernel`). L layers of 3x3 conv + bias (+ ReLU where
  `acts[l]`), each zero-padded on its own, float32 accumulation; the bias
  is rounded to the working dtype first and every layer's output is
  rounded to it, as the JAX chain (`vfi_tpu/models/layers.py::
  apply_conv_chain`) does. `conv_chain(x, weights, biases, acts,
  packed=None)`: x NHWC, weights OIHW (`nn.Conv2d.weight`), biases
  (cout,) or None; `packed` is `pack_conv_chain(weights, biases)` made
  ahead of time, or None to pack on this call. On the card: bf16 or
  float32, 1..4 layers, every cout <= 64 (`chain_plan`); the first layer
  takes any width (see "Inputs" below). Each layer runs as one launch of
  the single-conv kernel (its bf16 or float32 instance) on that layer's
  slice of the packed weights.
- `conv_chain_fused`, with `conv_chain`'s signature and contract, runs
  the chain of 2..4 layers as one launch of the fused chain kernel
  (`csrc/conv_chain.cu`, the counterpart of `_chain_kernel`: its bf16
  instance, or its float32 one, FFMA, no rounding but float32's) on
  `chain_fused_plan`. It is slower than `conv_chain` at every chain
  shape measured (`chain_plan`), so no model path calls it. A float32
  chain's packed weights are each layer's float32 `pack_conv2d` block,
  whose rows the fused kernel copies a channel chunk at a time.
- `conv2d` replaces `conv2d_pallas` (kernel `_conv_kernel`, variants
  "im2col" and "direct") and `conv2d_pallas_v2` (`_conv_kernel_v2`,
  variant "v2"): one stride-1 square odd-k conv, zeros padding k // 2, an
  optional bias and an optional fused ReLU, NHWC, float32 accumulation and
  one rounding of the output. On the card: bf16 or float32 (the kernel's
  float32 instance: 3xTF32 on the tensor cores, float32-accurate products
  summed in float32), k <= 9, Cout <= 128, any Cin, on the plan of
  `conv2d_plan`.

Inputs. `x` of `conv_chain`, `conv_chain_fused`, `conv2d` and
`ops/cuda/sampling.py`'s `deform_conv2d_bounded` is an NHWC tensor or a
sequence of two that split one input along channels (`as_parts`): a
concatenation the caller need not build. The bf16 conv kernel (`conv2d`,
`conv_chain`) and both designs of the bf16 DCN read their input where it
lies (`in_place`): a channels-contiguous view whose image, row and pixel
strides are multiples of 8 elements (0 too: an `expand`ed per-image
vector), or two such parts, the first a multiple of 8 channels wide; their
tile loaders load the channels past a part's end as zeros, so the result
equals the kernel's on the zero-padded concatenation bit for bit. A contiguous input
whose channels are not a multiple of 8 is copied zero-padded
(`pad_channels8`), and a view those loaders cannot read raises ValueError.
The float32 instances, the fused chain kernel and any input that needs a
gradient take one contiguous tensor: the wrapper concatenates and pads a
copy. Each wrapper counts its launches by how it took the input in
`launches_by_input`, keyed (form, dtype tag), the forms `INPUT_FORMS`.
`reads_views` says whether a call is on the path where the kernels read
in place; there, and only where the caller asks (`padded=True`), the
bounded warp and the DCN write an odd width padded to 8 and return its
view (`ops/cuda/sampling.py`), so that the next kernel needs no copy.

Weights are packed in the input's dtype (`pack_conv2d(..., dtype=)`), in
that instance's layout; packed weights of another dtype raise ValueError. Every launch key in
`launches_by_shape` ends with the instance's tag, "bf16" or "f32"
(`KERNEL_DTYPES`).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. On the card the result carries autograd when an input requires
grad: the chain's backward is autograd of `conv_chain_plain` (`grad.py`),
the conv's the closed form of the reference's `conv2d_fast`
(`conv2d_backward`).
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from vfi_tpu_torch.ops.cuda import build
from vfi_tpu_torch.ops.cuda.grad import differentiable, needs_grad

MAX_LAYERS = 4
MAX_COUT = 64
CONV2D_MAX_COUT = 128
CONV2D_MAX_K = 9
# conv2d_pallas's variants and conv2d_pallas_v2 ("v2"): TPU layouts of one
# function. They do not change the result; "v2" keeps v2's contract.
CONV2D_VARIANTS = ("im2col", "direct", "v2")
# The conv kernel's output tile (`csrc/conv2d.cu` TH x TW) and the padding
# of its shared-memory rows, in bf16 elements (PAD there).
TILE_H, TILE_W, ROW_PAD = 16, 16, 8
# Dynamic shared memory one block may opt into on an H100 (227 KB).
H100_SMEM_PER_BLOCK = 232448
# The kernels' element types: each instance's tag in the launch keys.
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# The float32 conv instance (`csrc/conv2d.cu` conv2d_f32_kernel, 3xTF32
# on mma.sync m16n8k8): the channel chunks it tries below the whole input,
# widest first (multiples of 8: one k-step), and the padding of its
# shared-memory rows in floats (F_PAD there).
F32_CHUNKS = (64, 32, 16, 8)
F32_ROW_PAD = 4
# Past this many columns of K (k * k * Cin8) the float32 conv's plan
# flushes each step's sums into float32 registers (`csrc/conv2d.cu`): the
# tensor cores' accumulation truncates, and over a longer K its drift
# nears 2^-14 of the output.
F32_FLUSH_K = 1152


def kernel_dtype(name: str, dtype: torch.dtype) -> str:
    """The tag of `dtype` among `KERNEL_DTYPES`; TypeError for any other
    (float16, float64, ...)."""
    tag = KERNEL_DTYPES.get(dtype)
    if tag is None:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, got "
                        f"{dtype}")
    return tag


# How a launch took its input (`launches_by_input`): "whole", one
# contiguous tensor whose channels are a multiple of 8; "view", one tensor
# read in place; "parts", two parts read in place; "copied", a tensor the
# wrapper made (the parts' concatenation, a zero-padded or contiguous copy).
INPUT_FORMS = ("whole", "view", "parts", "copied")


def as_parts(x) -> tuple:
    """`x`, an NHWC tensor or a sequence of one or two that split one input
    along channels (the first's channels first), as a tuple of tensors;
    ValueError for more parts or parts of other images, dtypes or
    devices."""
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"an input takes one or two parts, got {len(parts)}")
    if any(p.dim() != 4 for p in parts):
        raise ValueError(f"x must be NHWC, got shapes "
                         f"{[tuple(p.shape) for p in parts]}")
    a = parts[0]
    if len(parts) == 2 and (parts[1].shape[:3] != a.shape[:3]
                            or parts[1].dtype != a.dtype
                            or parts[1].device != a.device):
        raise ValueError(f"parts {tuple(a.shape)} {a.dtype} {a.device} and "
                         f"{tuple(parts[1].shape)} {parts[1].dtype} "
                         f"{parts[1].device} do not split one input")
    return parts


def cat_parts(x) -> torch.Tensor:
    """The one tensor of `x` (`as_parts`): its single part as it is, or its
    two parts concatenated along channels."""
    parts = as_parts(x)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def reads_views(x: torch.Tensor, *others) -> bool:
    """Whether a call on `x` is on the path where the bf16 conv and DCN
    kernels read views and parts in place (and where the bounded warp and
    the DCN write a padded buffer's view on request): a bf16 CUDA `x`, and
    no gradient to record for it or for `others` (the call's other tensors
    and parameters; None entries are skipped)."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and not needs_grad(x, *others))


def in_place(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels' tile loaders read NHWC `t` where it lies:
    channels contiguous, the image, row and pixel strides multiples of 8
    elements (16 bytes; 0 too), the first element on a 16-byte boundary."""
    sb, sy, sx, sc = t.stride()
    return (sc == 1 and sb % 8 == 0 and sy % 8 == 0 and sx % 8 == 0
            and t.data_ptr() % 16 == 0)


def kernel_input(x, name: str, views: bool) -> tuple:
    """(parts, form): the tensors a launch hands its kernel for input `x`
    (`as_parts`) and how (`INPUT_FORMS`). `views`: the kernel instance
    reads views and two parts in place (the bf16 conv and DCN); else it
    takes one contiguous tensor of a multiple of 8 channels, which the
    parts' concatenation, zero-padded, is copied into where `x` is not one.
    Raises ValueError for a view, or a part, the loaders cannot read."""
    parts = as_parts(x)
    t = parts[0]
    if len(parts) == 1 and t.is_contiguous() and t.shape[-1] % 8 == 0 \
            and t.data_ptr() % 16 == 0:
        return parts, "whole"
    if not views:
        return (pad_channels8(cat_parts(parts).contiguous()),), "copied"
    if len(parts) == 1:
        if t.is_contiguous():
            return (pad_channels8(t) if t.shape[-1] % 8 else t.clone(),), \
                "copied"
        if in_place(t):
            return parts, "view"
    elif t.shape[-1] % 8 == 0 and all(in_place(p) for p in parts):
        return parts, "parts"
    raise ValueError(
        f"{name} kernel reads a channels-contiguous view whose image, row "
        f"and pixel strides are multiples of 8 elements and that starts on "
        f"16 bytes, in one part or two (the first a multiple of 8 channels "
        f"wide), got parts of shapes {[tuple(p.shape) for p in parts]}, "
        f"strides {[p.stride() for p in parts]}")


def parts_args(parts: tuple) -> tuple:
    """The C entries' arguments for an input in parts (common.cuh
    InputParts): each part's pointer, image, row and pixel strides in
    elements and channels; zeros for an absent second part."""
    args = []
    for p in parts:
        args += [p.data_ptr(), *p.stride()[:3], p.shape[-1]]
    return (*args, *([0] * 5 * (2 - len(parts))))


def conv_chain_plain(x, weights: Sequence[torch.Tensor],
                     biases: Sequence[Optional[torch.Tensor]],
                     acts: Sequence[bool],
                     packed: Optional[tuple] = None) -> torch.Tensor:
    """The chain as L separate float32 convolutions on the working-dtype
    values (each layer rounded to x.dtype) of `x`, a tensor or its parts
    (`cat_parts`). It reads `weights`; `packed`, the kernel's copy of them,
    is taken only so that this function and `conv_chain` share one
    signature."""
    x = cat_parts(x)
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


def _pad8(c: int) -> int:
    return -(-c // 8) * 8


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def packed_shape(cin: int, cout: int, k: int, dtype: torch.dtype) -> tuple:
    """The shape of `pack_conv2d`'s weights for a Cin -> Cout k x k conv in
    `dtype`: bf16 [k * k * Cin16][Cout16] (K rows), float32 [Cout16][k * k
    * Cin8] (K contiguous, the 3xTF32 core's B operand)."""
    if dtype == torch.float32:
        return (_pad16(cout), k * k * _pad8(cin))
    return (k * k * _pad16(cin), _pad16(cout))


@functools.lru_cache(maxsize=None)
def conv2d_plan(cin: int, cout: int, k: int,
                limit: int = H100_SMEM_PER_BLOCK, itemsize: int = 2) -> dict:
    """The conv kernel's plan (`csrc/conv2d.cu`) for Cin -> Cout at k x k
    within `limit` bytes of shared memory per block, for its bf16
    instance (`itemsize` 2) or its float32 one (4, `_conv2d_plan_f32`).

    bf16: two input-tile
    buffers of (TILE_H + k - 1) x (TILE_W + k - 1) pixels x `ck` channels,
    then either the whole packed weight set (`resident`, copied once per
    block) or two buffers of `taps_per_group` taps x `ck` rows. It takes
    the first that fits of: resident weights with the whole Cin16, then
    with chunks of 64, 32, 16 channels; streamed tap groups (as few as fit,
    of equal size) with the whole Cin16, then chunks of 64, 32, 16. Raises
    ValueError past Cout 128 or k 9, or where nothing fits `limit`."""
    if not (1 <= cout <= CONV2D_MAX_COUT and 1 <= k <= CONV2D_MAX_K
            and k % 2 == 1 and cin >= 1):
        raise ValueError(f"conv2d kernel takes Cout <= {CONV2D_MAX_COUT} "
                         f"and odd k <= {CONV2D_MAX_K}, got Cin={cin}, "
                         f"Cout={cout}, k={k}")
    if itemsize == 4:
        return _conv2d_plan_f32(cin, cout, k, limit)
    if itemsize != 2:
        raise ValueError(f"conv2d kernel has bf16 and float32 instances, "
                         f"got itemsize {itemsize}")
    cin16, taps = _pad16(cin), k * k
    wrow = (_pad16(cout) + ROW_PAD) * 2
    tile_px = (TILE_H + k - 1) * (TILE_W + k - 1)
    cks = [cin16] + [c for c in (64, 32, 16) if c < cin16]

    def plan(ck, tg, resident):
        x_bytes = _round128(tile_px * (ck + ROW_PAD) * 2)
        w_bytes = (taps * cin16 if resident else 2 * tg * ck) * wrow
        return {"tile": f"{TILE_H}x{TILE_W}", "ck": ck,
                "chunks": -(-cin16 // ck), "resident": resident,
                "taps_per_group": tg, "groups": -(-taps // tg),
                "x_bytes": x_bytes, "smem_bytes": 2 * x_bytes + w_bytes}

    for ck in cks:
        p = plan(ck, taps, True)
        if p["smem_bytes"] <= limit:
            return p
    for ck in cks:
        free = limit - 2 * _round128(tile_px * (ck + ROW_PAD) * 2)
        fit = min(taps, free // (2 * ck * wrow))
        if fit >= 1:
            tg = -(-taps // -(-taps // fit))
            return plan(ck, tg, False)
    raise ValueError(f"conv2d kernel: no plan for Cin={cin}, Cout={cout}, "
                     f"k={k} fits {limit} bytes of shared memory per block")


def _conv2d_plan_f32(cin: int, cout: int, k: int, limit: int) -> dict:
    """The float32 instance's plan (`conv2d_f32_kernel`, 3xTF32 on the
    tensor cores): output tiles of `tile` (16 x 16 up to Cout16 = 64, else
    8 x 16), two input-tile buffers of (rows + k - 1) x (16 + k - 1) pixels
    x (`ck` + 4) floats, and the weights ([Cout16][K] rows of `w_pitch`
    floats) either resident (the whole k * k * Cin8 columns, copied once a
    block) or streamed in two slots of `taps_per_group` taps x `ck`
    columns. It takes the resident weights with the widest chunk of [Cin8]
    + F32_CHUNKS that fits `limit`, else the streamed (chunk, tap group)
    with the fewest steps a tile (chunks x groups; the wider chunk on a
    tie), each group as many taps as fit, evened over the groups. Past
    F32_FLUSH_K columns of K it flushes (`flush`) on tiles of half the
    rows, each step (a chunk's taps, resident; a tap group, streamed) then
    spanning at most F32_FLUSH_K columns. The FFMA design this replaced
    was slower at every float32 shape a path runs (device ms per launch,
    FFMA / 3xTF32, medians of two turns each of `tools/conv_turns.py` on
    an H100 at 700 W): 720p 64->64 1.996
    / 1.076, 128->64 3.857 / 2.240, 64->2 0.889 / 0.480, offset 64->27
    1.406 / 0.693, 64->32 1.239 / 0.663, 32->3 0.478 / 0.240; 360x640
    64->64 0.531 / 0.279, 128->64 1.001 / 0.563, 64->2 0.258 / 0.135,
    64->27 0.430 / 0.188."""
    cin8, cout16, taps = _pad8(cin), _pad16(cout), k * k
    flush = taps * cin8 > F32_FLUSH_K
    rows = (TILE_H if cout16 <= 64 else TILE_H // 2) // (2 if flush else 1)
    tile_px = (rows + k - 1) * (TILE_W + k - 1)
    cks = [cin8] + [c for c in F32_CHUNKS if c < cin8]
    cols = F32_FLUSH_K if flush else taps * cin8   # a step's columns, most

    def x_bytes(ck):
        return _round128(tile_px * (ck + F32_ROW_PAD) * 4)

    def plan(ck, tg, resident):
        w_pitch = (taps * cin8 if resident else tg * ck) + F32_ROW_PAD
        w_bytes = (1 if resident else 2) * cout16 * w_pitch * 4
        return {"core": "tf32x3", "flush": flush,
                "tile": f"{rows}x{TILE_W}", "ck": ck,
                "chunks": -(-cin8 // ck), "resident": resident,
                "taps_per_group": tg, "groups": -(-taps // tg),
                "x_bytes": x_bytes(ck), "w_pitch": w_pitch,
                "smem_bytes": 2 * x_bytes(ck) + w_bytes}

    for ck in cks:
        p = plan(ck, taps, True)
        if p["smem_bytes"] <= limit and taps * ck <= cols:
            return p
    best = None
    for ck in cks:
        free = limit - 2 * x_bytes(ck)
        fit = min(taps, cols // ck,
                  (free // (2 * cout16 * 4) - F32_ROW_PAD) // ck)
        if fit >= 1:
            p = plan(ck, -(-taps // -(-taps // fit)), False)
            if best is None or (p["chunks"] * p["groups"]
                                < best["chunks"] * best["groups"]):
                best = p
    if best is None:
        raise ValueError(f"conv2d kernel (float32): no plan for Cin={cin}, "
                         f"Cout={cout}, k={k} fits {limit} bytes of shared "
                         f"memory per block")
    return best


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    return torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin


def _launch_conv2d(xp: tuple, wpk: torch.Tensor, bpk: torch.Tensor,
                   out: torch.Tensor, k: int, act: bool, what: str) -> None:
    """One launch of the conv kernel's instance for the input's dtype: xp
    the input's parts as `kernel_input` gives them (bf16: read in place;
    float32: one contiguous tensor of Cin % 8 == 0), wpk (`packed_shape`)
    and bpk [Cout16] as `pack_conv2d` makes them in that dtype, into `out`
    (B, H, W, Cout), on the plan of `conv2d_plan`."""
    x0, cout = xp[0], out.shape[-1]
    (b, h, w, _), dev = x0.shape, x0.device
    cin = _pad8(sum(p.shape[-1] for p in xp))
    plan = conv2d_plan(cin, cout, k, _smem_limit(dev.index),
                       x0.element_size())
    io = (wpk.data_ptr(), bpk.data_ptr(), out.data_ptr(), b, h, w)
    step = (cout, k, int(act), plan["ck"],
            0 if plan["resident"] else plan["taps_per_group"],
            plan["x_bytes"])
    if x0.dtype == torch.float32:
        rc = build.entry("vfi_conv2d_f32")(
            x0.data_ptr(), *io, cin, *step, int(plan["flush"]),
            plan["smem_bytes"], dev.index, build.current_stream(dev.index))
    else:
        rc = build.entry("vfi_conv2d_bf16")(
            *parts_args(xp), *io, *step, plan["smem_bytes"], dev.index,
            build.current_stream(dev.index))
    if rc:
        build.check(rc, what)


def pad_channels8(x: torch.Tensor) -> torch.Tensor:
    """x with its channels zero-padded to a multiple of 8: the conv and
    DCN kernels copy their input tile in 16-byte units of 8 bf16 channels
    (the float32 instances take the same widths). A contiguous 67-channel
    input (134-byte pixels) becomes 72 channels; others pass unchanged."""
    c = x.shape[-1]
    return x if c % 8 == 0 else F.pad(x, (0, -c % 8))


def pack_conv2d(weight: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The conv and DCN kernels' weight layout for the instance of
    `dtype` (bf16 or float32, the input's): OIHW (Cout, Cin, kh, kw) ->
    bf16 [kh * kw * Cin16][Cout16] (K rows, tap-major, t = kw * i + j;
    channels padded to multiples of 16 with zeros), the B operand of
    ldmatrix.trans; float32 [Cout16][kh * kw * Cin8] (K contiguous, column
    t * Cin8 + c; Cin padded to 8, Cout to 16 with zeros), the B operand of
    the 3xTF32 core. Bias -> f32 [Cout16] (its values rounded to `dtype`,
    zeros for None and the padding). A module whose weights stay fixed
    packs them once and passes the result as `packed=`."""
    kernel_dtype("pack_conv2d", dtype)
    cout, cin, kh, kw = weight.shape
    cout16, dev = _pad16(cout), weight.device
    taps = weight.detach().to(dtype).permute(2, 3, 1, 0).reshape(
        kh * kw, cin, cout)
    if dtype == torch.float32:
        wpk = torch.zeros(cout16, kh * kw, _pad8(cin), dtype=dtype,
                          device=dev)
        wpk[:cout, :, :cin] = taps.permute(2, 0, 1)
    else:
        wpk = torch.zeros(kh * kw, _pad16(cin), cout16, dtype=dtype,
                          device=dev)
        wpk[:, :cin, :cout] = taps
    bpk = torch.zeros(cout16, dtype=torch.float32, device=dev)
    if bias is not None:
        bpk[:cout] = bias.detach().to(dtype).float()
    return wpk.reshape(packed_shape(cin, cout, kh, dtype)), bpk


def pack_conv_chain(weights: Sequence[torch.Tensor],
                    biases: Sequence[Optional[torch.Tensor]],
                    dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The chain kernel's weight layout: every layer's `pack_conv2d` block
    in `dtype` (`packed_shape`), concatenated into one buffer, and its
    [cout_p] f32 biases into another. A module whose weights stay fixed
    packs them once and passes the result as `conv_chain(..., packed=)`."""
    packs = [pack_conv2d(w, b, dtype) for w, b in zip(weights, biases)]
    return (torch.cat([w.reshape(-1) for w, _ in packs]),
            torch.cat([b for _, b in packs]))


# The fused chain kernel (`csrc/conv_chain.cu`): output tiles it may take,
# largest first, its warps, and the m16 fragments a warp holds at most.
CHAIN_TILES = ((16, 16), (8, 16), (8, 8))
CHAIN_WARPS = 8
CHAIN_MF = 4
# Its float32 instance: output tiles, largest first; input channels a
# weight chunk, widest first; output positions a lane holds at most
# (F_MP there); the padding of an activation row, in floats (F_PAD).
CHAIN_F32_TILES = ((8, 16), (8, 8), (4, 8))
CHAIN_F32_CHUNKS = (64, 32, 16, 8, 4)
CHAIN_F32_MP = 8
CHAIN_F32_PAD = 4


@functools.lru_cache(maxsize=None)
def chain_fused_plan(chans: tuple, limit: int = H100_SMEM_PER_BLOCK,
                     itemsize: int = 2) -> Optional[dict]:
    """The fused kernel's plan for a chain of widths `chans` (chans[0]
    the input's, which the kernel reads padded to a multiple of 8), for
    its bf16 instance (`itemsize` 2) or its float32 one (4,
    `_chain_fused_plan_f32`), or None where no tile fits and for one
    layer (the kernel takes 2..MAX_LAYERS).

    bf16: all layers share one flat pixel pitch P = TW + 2L (the tile's
    columns and halo); layer l computes the (TH + 2(L-1-l)) x P positions
    of its output region as m16 fragments of consecutive positions, which a
    tap reads at a flat offset in its input. Two activation buffers of
    `buf_px` positions (each position one row of Cin16 + 8 bf16 channels
    of the widest layer input) hold a layer's input and output in turn,
    and the next tile's input copies into the free one during the last
    layer; two weight slots hold `taps_per_group[l]` taps of layer l
    (Cin16 rows of Cout16 + 8) each, the next group copying while this
    one multiplies. The first tile of `CHAIN_TILES` whose layers need at
    most CHAIN_MF fragments a warp and whose buffers and slots (at least
    one tap of every layer) fit `limit` is taken; each layer's group is
    the most taps the slot holds, evened over its groups. (A 16 x 32 tile,
    1.34x the work of its outputs at L = 3 against 1.56x at 16 x 16, needs
    48 fragments a layer: more than 8 warps of CHAIN_MF hold.)"""
    if itemsize not in (2, 4):
        raise ValueError(f"conv_chain kernel has bf16 and float32 "
                         f"instances, got itemsize {itemsize}")
    if len(chans) < 3:
        return None
    if itemsize == 4:
        return _chain_fused_plan_f32(chans, limit)
    L = len(chans) - 1
    cins = [_pad16(c) for c in chans[:-1]]
    couts = [_pad16(c) for c in chans[1:]]
    tap_bytes = [ci * (co + ROW_PAD) * 2 for ci, co in zip(cins, couts)]
    pitch = max(cins) + ROW_PAD
    for th, tw in CHAIN_TILES:
        p_px = tw + 2 * L
        frags = [-(-(th + 2 * (L - 1 - l)) * p_px // 16) for l in range(L)]
        if max(frags) > CHAIN_WARPS * CHAIN_MF:
            continue
        buf_px = frags[0] * 16 + 2 * p_px + 2
        buf_bytes = _round128(buf_px * pitch * 2)
        slot = (limit - 2 * buf_bytes) // 2 // 128 * 128
        if slot < max(tap_bytes):
            continue
        tg = []
        for tb in tap_bytes:
            fit = min(9, slot // tb)
            tg.append(-(-9 // -(-9 // fit)))
        slot_bytes = _round128(max(t * tb for t, tb in zip(tg, tap_bytes)))
        return {"tile": f"{th}x{tw}", "th": th, "tw": tw, "pitch_px": p_px,
                "frags": frags, "buf_px": buf_px, "buf_bytes": buf_bytes,
                "taps_per_group": tg, "groups": [-(-9 // t) for t in tg],
                "slot_bytes": slot_bytes,
                "smem_bytes": 2 * buf_bytes + 2 * slot_bytes}
    return None


def _chain_fused_plan_f32(chans: tuple, limit: int) -> Optional[dict]:
    """The float32 instance's plan (`conv_chain_f32_kernel`).

    The same flat pitch P = TW + 2L. Two activation buffers with fixed
    roles: buffer 0 holds the even layers' inputs, buffer 1 the odd
    layers' (`buf_bytes`), layer l's input (TH + 2(L-l)) x P positions of
    `pitch[l]` = Cin16 + CHAIN_F32_PAD floats. The weights stream in
    chunks of `ck` input channels with all 9 taps ([9][ck][Cout16] floats)
    through two slots of `slot_bytes`. A warp owns 8 output channels of a
    layer and shares its output positions with the other warps of those
    channels (8 warps over Cout16 / 8 groups); a lane holds
    `positions_per_lane[l]` positions, at most CHAIN_F32_MP. The first
    tile of CHAIN_F32_TILES whose layers keep to CHAIN_F32_MP positions a
    lane and whose buffers and slots fit `limit` with some chunk of
    CHAIN_F32_CHUNKS is taken, with the widest such chunk."""
    L = len(chans) - 1
    cins = [_pad16(c) for c in chans[:-1]]
    couts = [_pad16(c) for c in chans[1:]]
    pitch = [c + CHAIN_F32_PAD for c in cins]
    for th, tw in CHAIN_F32_TILES:
        p_px = tw + 2 * L
        per_lane = []
        for l in range(L):
            n = (th + 2 * (L - 1 - l)) * (tw + 2 * (L - 1 - l))
            shares = CHAIN_WARPS // (couts[l] // 8)
            per_lane.append(-(-n // (32 * shares)))
        if max(per_lane) > CHAIN_F32_MP:
            continue
        bufs = [0, 0]
        for l in range(L):
            bufs[l % 2] = max(bufs[l % 2], _round128(
                4 * (th + 2 * (L - l)) * p_px * pitch[l]))
        for ck in CHAIN_F32_CHUNKS:
            slot_bytes = _round128(max(4 * 9 * min(ck, ci) * co
                                       for ci, co in zip(cins, couts)))
            smem = bufs[0] + bufs[1] + 2 * slot_bytes
            if smem <= limit:
                return {"tile": f"{th}x{tw}", "th": th, "tw": tw,
                        "pitch_px": p_px, "pitch": pitch,
                        "positions_per_lane": per_lane, "ck": ck,
                        "chunks": [-(-ci // ck) for ci in cins],
                        "buf_bytes": bufs, "slot_bytes": slot_bytes,
                        "smem_bytes": smem}
    return None


@functools.lru_cache(maxsize=None)
def chain_plan(chans: tuple, acts: tuple, b: int, h: int, w: int,
               limit: int = H100_SMEM_PER_BLOCK, itemsize: int = 2) -> list:
    """The chain's contract and its layers' plans: chans = (Cin, Cout_1,
    ..., Cout_L), `acts` the layers' ReLUs, a (b, h, w) input, `limit`
    bytes of shared memory a block, `itemsize` 2 (bf16) or 4 (float32).
    Pure and deterministic: nothing is timed at run time.

    Returns each layer's `conv2d_plan` at `itemsize` (the input width
    padded to 8; an intermediate's width too, its padding channels
    computed as exact zeros from the packed weights' zero columns): the
    conv-kernel launches of `conv_chain`, one a layer. Raises ValueError
    past the contract (`_chain_contract`).

    Why a chain runs as its layers and not as one launch of the fused
    kernel (`conv_chain_fused`): device time per launch in turns on an
    H100 (`tools/conv_turns.py`, PERF.md section 6): the layers beat the
    fused kernel at every chain shape a path launches (720p feat 0.727 /
    1.255 ms, motion 0.916 / 2.688, rec 0.527 / 0.834; 360x640, 4x480x640
    incl. rec67 and 4x240x320 alike) and on 1x16x32, 1x64x128 and
    1x128x256 frames (0.028-0.048 / 0.033-0.104 ms). A fused tile
    recomputes its halo (1.56x the work for three layers on 16 x 16
    outputs) and re-reads every layer's weights a tile; the layers pay one
    device-memory round trip of each intermediate, which at these widths
    costs less. In float32 too: medians of two turns each of
    `tools/conv_turns.py` on an H100 (700 W), fused (FFMA) / layers (the
    3xTF32 conv) / cuDNN float32 layer by layer, 720p feat 8.989 / 3.133 /
    7.030 ms, motion 17.621 / 3.712 / 7.776, rec 6.230 / 1.922 / 4.722;
    360x640 feat 2.309 / 0.792 / 1.999, motion 4.515 / 0.942 / 2.173: the
    fused kernel pays the halo's recompute (1.43x the work on 8 x 16
    tiles, 2.08x for motion on 8 x 8) on a core that runs its products at
    the float32 rate, the layers theirs on the tensor cores."""
    _chain_contract(chans, acts, b, h, w)
    widths = [_pad8(c) for c in chans[:-1]] + [chans[-1]]
    return [conv2d_plan(ci, co, 3, limit, itemsize)
            for ci, co in zip(widths[:-1], widths[1:])]


def _chain_contract(chans: tuple, acts: tuple, b: int, h: int,
                    w: int) -> None:
    """Both chain wrappers' contract: ValueError past 1..MAX_LAYERS layers,
    for `acts` not one a layer, a Cout past 1..MAX_COUT, an empty input
    width or a negative shape."""
    L = len(chans) - 1
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"conv_chain takes 1..{MAX_LAYERS} layers, got "
                         f"{L}")
    if len(acts) != L:
        raise ValueError(f"{len(acts)} acts for {L} layers")
    if chans[0] < 1 or not all(1 <= c <= MAX_COUT for c in chans[1:]):
        raise ValueError(f"conv_chain takes cout <= {MAX_COUT} (and every "
                         f"width >= 1), got channels {chans}")
    if min(b, h, w) < 0:
        raise ValueError(f"negative shape {(b, h, w)}")


def chain_layer_packs(wpk: torch.Tensor, bpk: torch.Tensor,
                      chans: Sequence[int]) -> list:
    """`conv_chain`'s weights a layer: views of `pack_conv_chain`'s
    buffers, one (wpk `packed_shape`, bpk [Cout16]) per layer, each
    exactly that layer's `pack_conv2d` block in wpk's dtype."""
    packs, wo, bo = [], 0, 0
    for ci, co in zip(chans[:-1], chans[1:]):
        shape = packed_shape(ci, co, 3, wpk.dtype)
        n = shape[0] * shape[1]
        packs.append((wpk[wo:wo + n].view(shape), bpk[bo:bo + _pad16(co)]))
        wo, bo = wo + n, bo + _pad16(co)
    return packs


def _launch_chain_layers(xp: tuple, wpk: torch.Tensor, bpk: torch.Tensor,
                         chans: tuple, acts: tuple) -> torch.Tensor:
    """`conv_chain`'s launches: one of the conv kernel a layer, on
    `chain_layer_packs`, the first on the input's parts `xp` as
    `kernel_input` gives them."""
    b, h, w, _ = xp[0].shape
    for l, (wl, bl) in enumerate(chain_layer_packs(wpk, bpk, chans)):
        co = chans[-1] if l == len(acts) - 1 else _pad8(chans[l + 1])
        out = xp[0].new_empty(b, h, w, co)
        _launch_conv2d(xp, wl, bl, out, 3, acts[l], "conv_chain")
        xp = (out,)
    return out


def _launch_chain_fused(xp: tuple, wpk: torch.Tensor, bpk: torch.Tensor,
                        chans: tuple, acts: tuple) -> torch.Tensor:
    """`conv_chain_fused`'s launch: one of the fused chain kernel's
    instance for the input's dtype on `chain_fused_plan`, xp one (B, H, W,
    C0 % 8 == 0) bf16 or float32 tensor. ValueError for one layer, and
    where no fused plan fits."""
    x0, L = xp[0], len(chans) - 1
    (b, h, w, _), dev = x0.shape, x0.device
    plan = chain_fused_plan(chans, _smem_limit(dev.index), x0.element_size())
    if plan is None:
        raise ValueError(f"conv_chain_fused: no fused plan for channels "
                         f"{chans} (one layer runs the conv kernel; wider "
                         f"inputs overrun shared memory)")
    out = x0.new_empty(b, h, w, chans[-1])
    cs = [x0.shape[-1]] + list(chans[1:]) + [0] * (MAX_LAYERS - L)
    act_mask = sum(1 << i for i, a in enumerate(acts) if a)
    head = (x0.data_ptr(), wpk.data_ptr(), bpk.data_ptr(), out.data_ptr(),
            b, h, w, L, *cs, act_mask, plan["th"], plan["tw"])
    tail = (plan["slot_bytes"], plan["smem_bytes"], dev.index,
            build.current_stream(dev.index))
    if x0.dtype == torch.float32:
        rc = build.entry("vfi_conv_chain_f32")(
            *head, plan["ck"], *plan["buf_bytes"], *tail)
    else:
        tg = plan["taps_per_group"] + [0] * (MAX_LAYERS - L)
        rc = build.entry("vfi_conv_chain_bf16")(
            *head, *tg, plan["buf_bytes"], *tail)
    if rc:
        build.check(rc, "conv_chain_fused")
    return out


def _chain(fn, x, weights, biases, acts,
           packed: Optional[tuple]) -> torch.Tensor:
    """A call of `fn`, `conv_chain` or `conv_chain_fused`, whose counters
    it raises: the argument checks, the plain version for a CPU tensor,
    `_chain_contract`, the packed weights and their checks, the input as
    `kernel_input` hands it over (`conv_chain`'s bf16 parts read in
    place), the launch (`_launch_chain_layers` or `_launch_chain_fused`),
    autograd through `differentiable`."""
    name, layers = fn.__name__, fn is conv_chain
    weights, biases, acts = list(weights), list(biases), tuple(acts)
    if not (len(weights) == len(biases) == len(acts)):
        raise ValueError("weights, biases and acts differ in length")
    parts = as_parts(x)
    x0 = parts[0]
    chans = [sum(p.shape[3] for p in parts)]
    for wt in weights:
        if (wt.dim() != 4 or wt.shape[2:] != (3, 3)
                or wt.shape[1] != chans[-1]):
            raise ValueError(f"layer weight {tuple(wt.shape)} is not OIHW "
                             f"3x3 with cin={chans[-1]}")
        chans.append(wt.shape[0])
    chans = tuple(chans)
    if x0.device.type == "cpu":
        return conv_chain_plain(parts, weights, biases, acts)
    if x0.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x0.device}")
    tag = kernel_dtype(name, x0.dtype)
    b, h, w, _ = x0.shape
    _chain_contract(chans, acts, b, h, w)
    if any(wt.device != x0.device for wt in weights):
        raise ValueError("weights must be on the input's device")
    wpk, bpk = packed or pack_conv_chain(weights, biases, x0.dtype)
    n_w = sum(9 * _pad8(ci) * _pad16(co) if x0.dtype == torch.float32
              else 9 * _pad16(ci) * _pad16(co)
              for ci, co in zip(chans[:-1], chans[1:]))
    if (wpk.numel() != n_w or wpk.device != x0.device
            or wpk.dtype != x0.dtype):
        raise ValueError("packed weights do not match this chain's "
                         "channels, device or dtype")
    # Autograd saves one input tensor: the parts' concatenation.
    grad = needs_grad(*parts, *weights, *biases)
    x = cat_parts(parts) if grad else parts
    xp, form = kernel_input(x, name, layers and tag == "bf16")
    if grad and len(parts) == 2:
        form = "copied"
    L = len(weights)
    launch = _launch_chain_layers if layers else _launch_chain_fused

    def run(*_):
        out = launch(xp, wpk, bpk, chans, acts)
        fn.launches += 1
        fn.launches_by_shape[(chans, h, w, tag)] += 1
        fn.launches_by_input[(form, tag)] += 1
        return out

    def plain(x, *wb):
        return conv_chain_plain(x, wb[:L], wb[L:], acts)

    if not grad:
        return run()
    return differentiable(run, plain, x, *weights, *biases)


def conv_chain(x, weights: Sequence[torch.Tensor],
               biases: Sequence[Optional[torch.Tensor]],
               acts: Sequence[bool],
               packed: Optional[tuple] = None) -> torch.Tensor:
    """The chain (the module docstring) as one conv-kernel launch a layer;
    a bf16 input or its parts are read in place where the conv kernel
    can (`kernel_input`)."""
    return _chain(conv_chain, x, weights, biases, acts, packed)


def conv_chain_fused(x, weights: Sequence[torch.Tensor],
                     biases: Sequence[Optional[torch.Tensor]],
                     acts: Sequence[bool],
                     packed: Optional[tuple] = None) -> torch.Tensor:
    """The chain as one launch of the fused chain kernel (the module
    docstring), with `conv_chain`'s arguments and contract. The kernel
    reads one contiguous tensor: two parts or a view are concatenated
    into a copy. On the card it raises ValueError for one layer, and where
    no fused plan fits."""
    return _chain(conv_chain_fused, x, weights, biases, acts, packed)


conv_chain.launches = 0
conv_chain.launches_by_shape = Counter()
# Launches by (form, dtype tag): how each took its input (INPUT_FORMS).
conv_chain.launches_by_input = Counter()
conv_chain_fused.launches = 0
conv_chain_fused.launches_by_shape = Counter()
conv_chain_fused.launches_by_input = Counter()


def conv2d_plain(x, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, act: bool = False,
                 variant: str = "im2col",
                 packed: Optional[tuple] = None) -> torch.Tensor:
    """One float32 convolution of the working-dtype values of `x`, a
    tensor or its parts (`cat_parts`): the weight and bias rounded to
    x.dtype, float32 accumulation, bias, ReLU, one rounding to x.dtype.
    `variant` and `packed` are taken only so that this function and
    `conv2d` share one signature."""
    x = cat_parts(x)
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.to(dt).float(),
                 padding=weight.shape[-1] // 2)
    if bias is not None:
        y = y + bias.to(dt).float()[:, None, None]
    if act:
        y = torch.relu(y)
    return y.to(dt).permute(0, 2, 3, 1).contiguous()


def conv2d_backward(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                    out: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor]) -> tuple:
    """(dx, dw, db) of `conv2d` given the output's cotangent `g`, in closed
    form as the reference's `_conv_bwd` (`vfi_tpu/ops/pallas/
    wrappers.py`): the ReLU mask from the saved output (`out`, None without
    a ReLU), dx the conv of g with the spatially flipped, IO-swapped
    weight, dw the correlation of x with g, db the sum of g; float32, each
    cast to its input's dtype. No forward is recomputed."""
    m = weight.shape[-1] // 2
    g = g.float()
    if out is not None:
        g = g * (out > 0)
    gn = g.permute(0, 3, 1, 2)
    db = None if bias is None else g.sum((0, 1, 2)).to(bias.dtype)
    dx = F.conv2d(gn, weight.float().flip(2, 3).transpose(0, 1), padding=m)
    dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2).float(),
                                     tuple(weight.shape), gn, padding=m)
    return (dx.permute(0, 2, 3, 1).to(x.dtype).contiguous(),
            dw.to(weight.dtype), db)


class Conv2dFunction(torch.autograd.Function):
    """forward: `launch(x, weight, bias)`; backward: `conv2d_backward`,
    with the ReLU mask read off the saved output where `act`."""

    @staticmethod
    def forward(ctx, launch, act: bool, x, weight, bias):
        out = launch(x, weight, bias)
        ctx.save_for_backward(x, weight, out if act else None, bias)
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, None, *conv2d_backward(g, *ctx.saved_tensors))


def conv2d(x, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, act: bool = False,
           variant: str = "im2col",
           packed: Optional[tuple] = None) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC, or its two parts split along channels (the
    module docstring's "Inputs"); weight OIHW (Cout, Cin, k, k), k odd;
    bias (Cout,) or None; `act` fuses a ReLU; `variant` one of
    `CONV2D_VARIANTS` (TPU layouts of the same function; "v2" keeps
    `conv2d_pallas_v2`'s refusals: Cin in {64, 128}, W a multiple of
    128 // Cin); `packed` is `pack_conv2d(weight, bias)` made ahead of
    time, or None to pack on this call. Returns (B, H, W, Cout)."""
    parts = as_parts(x)
    x0 = parts[0]
    (b, h, w, _), cin = x0.shape, sum(p.shape[3] for p in parts)
    if (weight.dim() != 4 or weight.shape[1] != cin
            or weight.shape[2] != weight.shape[3] or weight.shape[2] % 2 != 1):
        raise ValueError(f"weight {tuple(weight.shape)} is not OIHW square "
                         f"odd-k with cin={cin}")
    if variant not in CONV2D_VARIANTS:
        raise ValueError(f"variant must be one of {CONV2D_VARIANTS}, got "
                         f"{variant!r}")
    if variant == "v2" and (cin not in (64, 128) or w % (128 // cin)):
        raise ValueError(f"v2 packed conv supports C in {{64, 128}} with W "
                         f"a multiple of 128 // C, got C={cin}, W={w}")
    if x0.device.type == "cpu":
        return conv2d_plain(parts, weight, bias, act)
    if x0.device.type != "cuda":
        raise ValueError(f"conv2d: unsupported device {x0.device}")
    tag = kernel_dtype("conv2d", x0.dtype)
    cout, k = weight.shape[0], weight.shape[2]
    if cout > CONV2D_MAX_COUT or k > CONV2D_MAX_K:
        raise ValueError(f"conv2d kernel takes Cout <= {CONV2D_MAX_COUT} and "
                         f"k <= {CONV2D_MAX_K}, got Cout={cout}, k={k}")
    if weight.device != x0.device or (bias is not None
                                      and bias.device != x0.device):
        raise ValueError("weight and bias must be on the input's device")
    wpk, bpk = packed or pack_conv2d(weight, bias, x0.dtype)
    if (tuple(wpk.shape) != packed_shape(cin, cout, k, x0.dtype)
            or wpk.device != x0.device or wpk.dtype != x0.dtype):
        raise ValueError("packed weights do not match this conv's shape, "
                         "device or dtype")
    # Autograd saves one input tensor: the parts' concatenation.
    grad = needs_grad(*parts, weight, bias)
    x = cat_parts(parts) if grad else parts
    xp, form = kernel_input(x, "conv2d", tag == "bf16")
    if grad and len(parts) == 2:
        form = "copied"

    def launch(*_):
        out = torch.empty(b, h, w, cout, dtype=x0.dtype, device=x0.device)
        _launch_conv2d(xp, wpk, bpk, out, k, act, "conv2d")
        conv2d.launches += 1
        conv2d.launches_by_shape[(cin, cout, k, h, w, tag)] += 1
        conv2d.launches_by_input[(form, tag)] += 1
        return out

    if grad:
        return Conv2dFunction.apply(launch, act, x, weight, bias)
    return launch()


conv2d.launches = 0
conv2d.launches_by_shape = Counter()
# Launches by (form, dtype tag): how each took its input (INPUT_FORMS).
conv2d.launches_by_input = Counter()
