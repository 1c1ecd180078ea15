"""The port's CUDA kernels vs their plain versions on the card, at small
shapes with ragged edges (the main paths' full-size shapes run in
chip_smoke.py): the DCN under v4's contract (C in {64, 67} x R 1..4, with
and without a mask) and, on the stream design, at widths and radii no
tile plan holds, the chains with a 67-wide first layer (one layer through
the conv kernel), the single conv at k 1..9 with its tile cut at every edge,
the warp at C=3 and wide C, gradients through every kernel wrapper
against those through its plain version, q12 (the 67-channel
topology) through the engine with both conv_kernel settings, the
flagship engine (io_uint8) behind the HTTP server, and the kernels'
float32 instances (conv, the chain through its layers and fused, DCN
tile and stream designs, the three warp instances, their gradients, the
float32 engine and train step), and the engine's CUDA graphs (replays
bit-equal to the eager launches, their port kernels read off the device
trace, at qocc's and q12's topologies in bf16 and float32, after
eviction, on a capture from another thread, and past a failed capture).
Needs an
NVIDIA GPU and nvcc; skips without a GPU. Run on
the card with `python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`
(tests/conftest.py imports jax, which a GPU host that runs only the port
need not have).

Tolerance: two bf16 ulps at the top of the output's range (2**-7 *
max|plain|): kernel and plain version differ only in float32 summation
order, which can move a bf16 rounding by one ulp. Gradients: the same,
against max|plain gradient| (the DCN, chain and warp backward is autograd
of the plain version; the conv's closed form reads its ReLU mask off the
kernel's output). Engine against its plain-version engine: 40 dB, as
chip_smoke.py. Float32 instances: conv and DCN within 2**-14 max|plain|
(float32 sums in another order), the warps bit for bit (the plain
version's arithmetic), the float32 engine within 2**-12 of its
plain-version engine."""

import copy
import os

import numpy as np
import pytest
import torch

from vfi_tpu_torch.ops.cuda import (bounded_warp, bounded_warp_plain,
                                    conv2d, conv2d_plain,
                                    conv2d_plan, conv_chain,
                                    conv_chain_fused, conv_chain_plain,
                                    dcn_plan,
                                    deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain,
                                    hand_backward, launch_counts,
                                    reset_launch_counts)
from vfi_tpu_torch.ops.deform_conv_shifts import deform_conv2d_shifts_bwd

pytestmark = pytest.mark.cuda
REL_TOL = 2.0 ** -7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL * ref.float().abs().max().item()


def _rnd(gen, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)


@pytest.mark.parametrize("fused", [False, True], ids=["layers", "fused"])
@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (40, 72)])
@pytest.mark.parametrize("chans,acts", [
    ((64, 64, 64, 64), (True, True, True)),
    ((128, 64, 64, 2), (True, True, False)),
    ((64, 27), (False,)),
    ((64, 64, 32, 3), (True, True, False)),
    ((16, 48, 16, 8, 5), (True, False, True, False)),
    ((67, 64, 32, 3), (True, True, False)),
    ((67, 27), (False,)),
    ((3, 16), (True,)),
    ((24, 8), (False,)),
    ((128, 64, 64, 64, 64), (True, True, True, False)),
    ((8, 27, 19, 64), (True, False, True)),
])
def test_conv_chain_kernel(dev, hw, chans, acts, fused):
    """Every chain through `conv_chain` (one conv-kernel launch a layer,
    csrc/conv2d.cu) and through `conv_chain_fused` (the chain kernel,
    which a chain of one layer refuses); one launch counted by the wrapper
    that ran, under the chain's shape, none by the other."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _rnd(gen, dev, 2, *hw, chans[0])
    ws = [torch.randn(co, ci, 3, 3, generator=gen, device=dev) / (9 * ci) ** .5
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [torch.randn(co, generator=gen, device=dev) * 0.1 for co in chans[1:]]
    fn, other = ((conv_chain_fused, conv_chain) if fused
                 else (conv_chain, conv_chain_fused))
    reset_launch_counts()
    if fused and len(ws) == 1:
        with pytest.raises(ValueError, match="fused"):
            fn(x, ws, bs, acts)
        return
    got = fn(x, ws, bs, acts)
    assert fn.launches == 1 and other.launches == 0
    assert launch_counts()["conv2d"] == 0
    assert dict(fn.launches_by_shape) == {(chans, *hw, "bf16"): 1}
    _close(got, conv_chain_plain(x, ws, bs, acts))


def test_conv_chain_entry_refuses_one_layer(dev):
    """The chain kernel's C entry takes 2..4 layers; `conv_chain` sends a
    single layer to the conv kernel instead."""
    from vfi_tpu_torch.ops.cuda import build, pack_conv_chain

    x = torch.zeros(1, 8, 16, 64, dtype=torch.bfloat16, device=dev)
    w = [torch.zeros(27, 64, 3, 3, device=dev)]
    wpk, bpk = pack_conv_chain(w, [None])
    out = torch.empty(1, 8, 16, 27, dtype=torch.bfloat16, device=dev)
    args = (x.data_ptr(), wpk.data_ptr(), bpk.data_ptr(), out.data_ptr(),
            1, 8, 16)
    tail = (0, 8, 16, 9, 9, 9, 9, 1 << 16, 1 << 15, 1 << 17, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    lib = build.load()
    assert lib.vfi_conv_chain_bf16(*args, 1, 64, 27, 0, 0, 0, *tail) != 0
    assert lib.vfi_conv_chain_bf16(*args, 5, 64, 27, 27, 27, 27, *tail) != 0


def test_conv_chain_entry_refuses_a_plan_that_overruns(dev):
    """The C entry recomputes the plan's buffers and refuses one whose
    shared memory is short, as the conv kernel's entry does."""
    from vfi_tpu_torch.ops.cuda import build, pack_conv_chain
    from vfi_tpu_torch.ops.cuda.conv import chain_fused_plan

    chans = (64, 64, 64, 64)
    x = torch.zeros(1, 16, 16, 64, dtype=torch.bfloat16, device=dev)
    w = [torch.zeros(64, 64, 3, 3, device=dev)] * 3
    wpk, bpk = pack_conv_chain(w, [None] * 3)
    out = torch.empty(1, 16, 16, 64, dtype=torch.bfloat16, device=dev)
    p = chain_fused_plan(chans)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.load()

    def call(buf, slot, smem, tg=p["taps_per_group"]):
        return lib.vfi_conv_chain_bf16(
            x.data_ptr(), wpk.data_ptr(), bpk.data_ptr(), out.data_ptr(),
            1, 16, 16, 3, *chans, 0, 7, p["th"], p["tw"], *tg, 0, buf,
            slot, smem, dev.index, stream)

    assert call(p["buf_bytes"], p["slot_bytes"], p["smem_bytes"]) == 0
    torch.cuda.synchronize()
    assert call(p["buf_bytes"] - 128, p["slot_bytes"], p["smem_bytes"]) != 0
    assert call(p["buf_bytes"], p["slot_bytes"] - 128,
                p["smem_bytes"]) != 0
    assert call(p["buf_bytes"], p["slot_bytes"], p["smem_bytes"] - 1) != 0
    assert call(p["buf_bytes"], p["slot_bytes"], p["smem_bytes"],
                [9, 9, 9]) != 0


@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (24, 130)])
@pytest.mark.parametrize("cin,cout,R", [(64, 64, 1), (16, 32, 2), (32, 16, 3)])
def test_deform_conv2d_bounded_kernel(dev, hw, cin, cout, R):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = _rnd(gen, dev, 2, *hw, cin)
    off = _rnd(gen, dev, 2, *hw, 18, scale=0.8 * R)
    mask = torch.sigmoid(_rnd(gen, dev, 2, *hw, 9, scale=2.0).float()).to(
        torch.bfloat16)
    w = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) / (9 * cin) ** .5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert launch_counts()["deform_conv2d_bounded"] == 1
    _close(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("hw", [(13, 37), (24, 130)])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("R", [1, 2, 3, 4])
@pytest.mark.parametrize("cin", [64, 67])
def test_deform_conv2d_bounded_kernel_v4_contract(dev, hw, cin, R,
                                                  with_mask):
    """v4's contract: any C (the 67-channel reference topology), R 1..4,
    an optional mask (None: weight 1)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _rnd(gen, dev, 2, *hw, cin)
    off = _rnd(gen, dev, 2, *hw, 18, scale=0.8 * R)
    mask = (torch.sigmoid(_rnd(gen, dev, 2, *hw, 9, scale=2.0).float()).to(
        torch.bfloat16) if with_mask else None)
    w = torch.randn(cin, cin, 3, 3, generator=gen, device=dev) / (
        9 * cin) ** .5
    b = torch.randn(cin, generator=gen, device=dev) * 0.1
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert launch_counts()["deform_conv2d_bounded"] == 1
    _close(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("cin,cout,R", [(64, 128, 1), (67, 5, 2), (3, 24, 2),
                                        (80, 67, 4)])
def test_deform_conv2d_bounded_kernel_channel_counts(dev, cin, cout, R):
    gen = torch.Generator(device=dev).manual_seed(5)
    hw = (13, 70)
    x = _rnd(gen, dev, 1, *hw, cin)
    off = _rnd(gen, dev, 1, *hw, 18, scale=0.8 * R)
    mask = torch.sigmoid(_rnd(gen, dev, 1, *hw, 9).float()).to(torch.bfloat16)
    w = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) / (
        9 * cin) ** .5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    _close(deform_conv2d_bounded(x, off, mask, w, b, R),
           deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("cin,cout,R,tile,chunks", [
    (67, 67, 8, "8x16", 1), (128, 128, 4, "8x16", 1),
    (128, 128, 8, "8x16", 2), (128, 128, 6, "8x16", 2),
    (67, 67, 20, "8x16", 5)])
def test_deform_conv2d_bounded_kernel_any_radius(dev, cin, cout, R, tile,
                                                 chunks):
    """Shapes no tile plan holds run the stream design (weights streamed a
    tap at a time, the input in channel chunks): the plan is the one
    named."""
    plan = dcn_plan(cin, cout, R, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin)
    assert (plan["design"], plan["tile"], plan["chunks"]) == ("stream", tile,
                                                              chunks)
    gen = torch.Generator(device=dev).manual_seed(7)
    hw = (2 * R + 9, 70)
    x = _rnd(gen, dev, 1, *hw, cin)
    off = _rnd(gen, dev, 1, *hw, 18, scale=0.8 * R)
    mask = torch.sigmoid(_rnd(gen, dev, 1, *hw, 9).float()).to(torch.bfloat16)
    w = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) / (
        9 * cin) ** .5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert launch_counts()["deform_conv2d_bounded"] == 1
    _close(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


# The stream design at ragged sizes: H and W odd and below one 8 x 16
# tile, ragged edges, and (100, 300) at B = 3 (more tiles than the
# persistent grid's blocks); one chunk and several, Cout below 16 and off
# a multiple of 8, the odd pixel stride and the unpadded one, and 4 x 16
# tiles up to R = 35.
@pytest.mark.parametrize("hw", [(5, 7), (13, 37), (100, 300)])
@pytest.mark.parametrize("cin,cout,R,tile,chunks", [
    (128, 128, 4, "8x16", 1), (67, 67, 8, "8x16", 1),
    (128, 128, 8, "8x16", 2), (128, 27, 6, "8x16", 2),
    (128, 64, 1, "8x16", 1), (128, 8, 10, "8x16", 2),
    (67, 128, 12, "8x16", 2), (64, 64, 9, "8x16", 1),
    (128, 8, 29, "8x16", 8), (128, 8, 28, "4x16", 8),
    (128, 128, 35, "4x16", 8)])
def test_deform_conv2d_bounded_stream_plans(dev, hw, cin, cout, R, tile,
                                            chunks):
    plan = dcn_plan(cin, cout, R, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin)
    assert (plan["design"], plan["tile"], plan["nbuf"],
            plan["chunks"]) == ("stream", tile, 1, chunks)
    x, off, mask, w, b = _dcn_case(dev, 15, 3, hw, cin, cout, R)
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert launch_counts()["deform_conv2d_bounded"] == 1
    _close(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("with_mask", [True, False])
def test_deform_conv2d_bounded_stream_without_a_mask(dev, with_mask):
    x, off, mask, w, b = _dcn_case(dev, 16, 2, (19, 45), 128, 128, 4,
                                   with_mask)
    assert dcn_plan(128, 128, 4)["design"] == "stream"
    _close(deform_conv2d_bounded(x, off, mask, w, b, 4),
           deform_conv2d_bounded_plain(x, off, mask, w, b, 4))


def _dcn_case(dev, seed, b, hw, cin, cout, R, with_mask=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _rnd(gen, dev, b, *hw, cin)
    off = _rnd(gen, dev, b, *hw, 18, scale=0.8 * max(R, 1))
    mask = (torch.sigmoid(_rnd(gen, dev, b, *hw, 9, scale=2.0).float()).to(
        torch.bfloat16) if with_mask else None)
    w = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) / (
        9 * cin) ** .5
    bias = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, off, mask, w, bias


# Every branch of the tile design's plan: 16 x 16 output tiles with two
# input buffers and with one, 8 x 16 tiles with one, each at H and W below
# one tile, ragged edges, and (100, 300) at B = 3: more tiles than the
# persistent grid's blocks (one a SM, 132 on an H100).
@pytest.mark.parametrize("hw", [(5, 7), (13, 37), (100, 300)])
@pytest.mark.parametrize("cin,cout,R,tile,nbuf", [
    (64, 64, 1, "16x16", 2), (64, 64, 3, "16x16", 1), (67, 67, 2, "16x16", 1),
    (64, 64, 5, "16x16", 1), (64, 64, 8, "8x16", 1), (67, 67, 4, "8x16", 1)])
def test_deform_conv2d_bounded_tile_plans(dev, hw, cin, cout, R, tile, nbuf):
    plan = dcn_plan(cin, cout, R, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin)
    assert (plan["design"], plan["tile"], plan["nbuf"]) == ("tile", tile,
                                                            nbuf)
    x, off, mask, w, b = _dcn_case(dev, 11, 3, hw, cin, cout, R)
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert launch_counts()["deform_conv2d_bounded"] == 1
    _close(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("R", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("cout", [27, 64, 67])
def test_deform_conv2d_bounded_tile_channels_and_radii(dev, cout, R,
                                                       with_mask):
    """The tile design at Cout 27 and 67 (2-byte stores), R 0..4, B = 3,
    with and without a mask."""
    x, off, mask, w, b = _dcn_case(dev, 12, 3, (19, 45), 64, cout, R,
                                   with_mask)
    assert dcn_plan(64, cout, R)["design"] == "tile"
    _close(deform_conv2d_bounded(x, off, mask, w, b, R),
           deform_conv2d_bounded_plain(x, off, mask, w, b, R))


def test_deform_conv2d_bounded_takes_an_offset_view_off_word_alignment(dev):
    """The tile design reads a tap's (dy, dx) as one 4-byte word; an offset
    tensor one element into its storage is copied to an aligned one first,
    and the result is the plain version's."""
    x, off, mask, w, b = _dcn_case(dev, 14, 2, (13, 37), 64, 64, 1)
    store = torch.empty(off.numel() + 1, dtype=off.dtype, device=dev)
    store[1:] = off.reshape(-1)
    view = store[1:].view(off.shape)
    assert view.is_contiguous() and view.data_ptr() % 4
    _close(deform_conv2d_bounded(x, view, mask, w, b, 1),
           deform_conv2d_bounded_plain(x, off, mask, w, b, 1))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("hw", [(7, 9), (13, 37), (31, 33), (176, 1000),
                                (181, 1001)])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_bounded_warp_rgb_instance_is_bit_exact(dev, c, hw, aligned):
    """The RGB instance (two pixels a thread, 16 x 32 pixel tiles) equals
    its plain version bit for bit at odd W, B = 3, C = 1..4, ragged tiles
    and a grid of over 1,000 blocks, with the flow and output on their
    vector alignment and (a view one element into its storage) off it,
    which takes the 2-byte path."""
    gen = torch.Generator(device=dev).manual_seed(13)
    img = torch.rand(3, *hw, c, generator=gen, device=dev).to(torch.bfloat16)
    flow = _rnd(gen, dev, 3, *hw, 2, scale=12.0)
    if not aligned:
        store = torch.empty(flow.numel() + 1, dtype=flow.dtype, device=dev)
        store[1:] = flow.reshape(-1)
        flow = store[1:].view(flow.shape)
        assert flow.is_contiguous() and flow.data_ptr() % 16
    reset_launch_counts()
    got = bounded_warp(img, flow, 16)
    assert launch_counts()["bounded_warp"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, bounded_warp_plain(img, flow, 16))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("hw", [(3, 5), (7, 31), (9, 33), (40, 17),
                                (37, 70), (2, 7)])
@pytest.mark.parametrize("c", [8, 64, 67, 128, 24])
def test_bounded_warp_wide_instance_is_bit_exact(dev, c, hw, aligned):
    """The wide instance (4 x 8 pixel tiles, two 8-channel groups a thread
    with 16-byte corner reads where C % 8 == 0; one thread per pixel and
    group with 2-byte reads otherwise) equals its plain version bit for
    bit at B = 3, on images narrower and shorter than a tile and with
    ragged tiles, at C = 8, 24, 64, 67 and 128, with the image on its
    16-byte alignment and (a view one element into its storage) off it,
    which takes the 2-byte reads."""
    gen = torch.Generator(device=dev).manual_seed(17)
    img = torch.rand(3, *hw, c, generator=gen, device=dev).to(torch.bfloat16)
    flow = _rnd(gen, dev, 3, *hw, 2, scale=12.0)
    if not aligned:
        store = torch.empty(img.numel() + 1, dtype=img.dtype, device=dev)
        store[1:] = img.reshape(-1)
        img = store[1:].view(img.shape)
        assert img.is_contiguous() and img.data_ptr() % 16
    reset_launch_counts()
    got = bounded_warp(img, flow, 16)
    assert launch_counts()["bounded_warp"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, bounded_warp_plain(img, flow, 16))


@pytest.mark.parametrize("cin,cout,R", [(64, 129, 1), (16, 16, 37),
                                        (128, 128, 36)])
def test_deform_conv2d_bounded_refuses_what_no_plan_holds(dev, cin, cout, R):
    """Cout > 128, or an R whose 4 x 16 tile in 16-channel chunks exceeds
    the per-block shared memory, raises ValueError before any launch; no
    plain route is taken."""
    x = torch.zeros(1, 8, 16, cin, dtype=torch.bfloat16, device=dev)
    off = torch.zeros(1, 8, 16, 18, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(cout, cin, 3, 3, device=dev)
    reset_launch_counts()
    with pytest.raises(ValueError):
        deform_conv2d_bounded(x, off, None, w, None, R)
    assert launch_counts()["deform_conv2d_bounded"] == 0


# The conv kernel's 16 x 16 output tile cut at every edge: H and W not
# multiples of it, W below one tile, and (100, 300) at B = 3: 399 tiles,
# more than the persistent grid's blocks (at most 2 a SM, 264 on an H100).
@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (17, 130), (9, 7),
                                (100, 300)])
@pytest.mark.parametrize("cin,cout,k,act", [
    (64, 64, 3, True), (128, 64, 3, True), (64, 32, 3, False),
    (6, 64, 3, True), (64, 32, 1, False), (16, 128, 1, True),
    (64, 64, 5, True), (67, 5, 5, False), (24, 3, 7, True),
    (200, 40, 9, True), (64, 27, 3, False), (67, 27, 3, False)])
def test_conv2d_kernel(dev, hw, cin, cout, k, act):
    gen = torch.Generator(device=dev).manual_seed(8)
    x = _rnd(gen, dev, 3, *hw, cin)
    w = torch.randn(cout, cin, k, k, generator=gen, device=dev) / (
        k * k * cin) ** .5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    reset_launch_counts()
    got = conv2d(x, w, b, act)
    assert launch_counts()["conv2d"] == 1
    _close(got, conv2d_plain(x, w, b, act))
    _close(conv2d(x, w, None, act), conv2d_plain(x, w, None, act))


@pytest.mark.parametrize("cin,cout,k", [(16, 129, 3), (16, 16, 11)])
def test_conv2d_kernel_refuses_past_its_limits(dev, cin, cout, k):
    x = torch.zeros(1, 8, 16, cin, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(cout, cin, k, k, device=dev)
    reset_launch_counts()
    with pytest.raises(ValueError):
        conv2d(x, w)
    assert launch_counts()["conv2d"] == 0


@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (33, 140)])
@pytest.mark.parametrize("R", [4, 16])
@pytest.mark.parametrize("c", [3, 6, 64, 67])
def test_bounded_warp_kernel(dev, hw, R, c):
    """C <= 4 the RGB instance, wider the float32-blend one (v1's
    contract)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    img = _rnd(gen, dev, 2, *hw, c)
    flow = _rnd(gen, dev, 2, *hw, 2, scale=1.5 * R)
    reset_launch_counts()
    got = bounded_warp(img, flow, R)
    assert launch_counts()["bounded_warp"] == 1
    _close(got, bounded_warp_plain(img, flow, R))


def _grads(fn, inputs, cot_seed=9):
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in inputs]
    out = fn(*leaves)
    cot = torch.randn(out.shape, device=out.device,
                      generator=torch.Generator(out.device).manual_seed(
                          cot_seed))
    (out.float() * cot).sum().backward()
    return out, [None if t is None else t.grad for t in leaves]


def _grad_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(10)
    x = _rnd(gen, dev, 2, 13, 37, 64)
    ws = [torch.randn(co, 64, 3, 3, generator=gen, device=dev) / 24
          for co in (64, 27)]
    bs = [torch.randn(co, generator=gen, device=dev) * 0.1 for co in (64, 27)]
    off = _rnd(gen, dev, 2, 13, 37, 18, scale=1.5)
    mask = torch.sigmoid(_rnd(gen, dev, 2, 13, 37, 9).float()).to(
        torch.bfloat16)
    flow = _rnd(gen, dev, 2, 13, 37, 2, scale=3.0)
    img3 = _rnd(gen, dev, 2, 13, 37, 3)
    x128 = _rnd(gen, dev, 2, 13, 37, 128)   # the stream design's width
    return {
        "conv2d": (lambda x, w, b: conv2d(x, w, b, True),
                   lambda x, w, b: conv2d_plain(x, w, b, True),
                   [x, ws[1], bs[1]]),
        "conv_chain": (
            lambda x, *p: conv_chain(x, p[:2], p[2:], (True, False)),
            lambda x, *p: conv_chain_plain(x, p[:2], p[2:], (True, False)),
            [x, ws[0], torch.randn(8, 64, 3, 3, generator=gen, device=dev)
             / 24, bs[0], None]),
        "conv_chain_fused": (
            lambda x, *p: conv_chain_fused(x, p[:2], p[2:], (True, False)),
            lambda x, *p: conv_chain_plain(x, p[:2], p[2:], (True, False)),
            [x, ws[0], torch.randn(8, 64, 3, 3, generator=gen, device=dev)
             / 24, bs[0], None]),
        "deform_conv2d_bounded": (
            lambda *a: deform_conv2d_bounded(*a, 2),
            lambda *a: deform_conv2d_bounded_plain(*a, 2),
            [x, off, mask, ws[0], bs[0]]),
        "deform_conv2d_bounded_no_mask": (
            lambda x, o, w: deform_conv2d_bounded(x, o, None, w, None, 1),
            lambda x, o, w: deform_conv2d_bounded_plain(x, o, None, w, None,
                                                        1),
            [x, off, ws[0]]),
        "deform_conv2d_bounded_stream": (
            lambda *a: deform_conv2d_bounded(*a, 4),
            lambda *a: deform_conv2d_bounded_plain(*a, 4),
            [x128, off, mask,
             torch.randn(128, 128, 3, 3, generator=gen, device=dev) / 34,
             bs[0].repeat(2)]),
        "bounded_warp": (lambda i, f: bounded_warp(i, f, 4),
                         lambda i, f: bounded_warp_plain(i, f, 4),
                         [img3, flow]),
        "bounded_warp_wide": (lambda i, f: bounded_warp(i, f, 4),
                              lambda i, f: bounded_warp_plain(i, f, 4),
                              [x, flow]),
    }


@pytest.mark.parametrize("name", [
    "conv2d", "conv_chain", "conv_chain_fused", "deform_conv2d_bounded",
    "deform_conv2d_bounded_no_mask", "deform_conv2d_bounded_stream",
    "bounded_warp", "bounded_warp_wide"])
def test_gradients_through_the_kernels_match_the_plain_versions(dev, name):
    """The kernel's output carries a grad_fn whenever an input requires
    grad, and every gradient matches the one through the plain version and
    is non-zero wherever that one is."""
    kernel, plain, inputs = _grad_cases(dev)[name]
    reset_launch_counts()
    out, gk = _grads(kernel, inputs)
    assert out.grad_fn is not None
    assert sum(launch_counts().values()) == 1
    _, gp = _grads(plain, inputs)
    for a, b in zip(gk, gp):
        if b is None:
            continue
        _close(a, b)
        assert not ((a == 0) & (b != 0)).any()


@pytest.mark.parametrize("cin,R", [(64, 1), (64, 2), (128, 4)])
def test_hand_backward_on_the_kernel(dev, cin, R):
    """Inside hand_backward() the kernel's forward carries the
    hand-written backward: one launch, no recomputed forward, and the
    gradients are deform_conv2d_shifts_bwd's on the saved inputs (up to
    the order of its float32 atomic adds)."""
    x, off, mask, w, bias = _dcn_case(dev, 7, 2, (24, 40), cin, cin, R)
    leaves = [t.detach().clone().requires_grad_() for t in
              (x, off, mask, w, bias)]
    g = torch.randn(2, 24, 40, cin, device=dev).to(torch.bfloat16)
    reset_launch_counts()
    with hand_backward():
        out = deform_conv2d_bounded(*leaves, R)
    _close(out, deform_conv2d_bounded_plain(x, off, mask, w, bias, R))
    out.backward(g)
    assert launch_counts()["deform_conv2d_bounded"] == 1
    want = deform_conv2d_shifts_bwd(x, off, mask, w, bias, g, max_offset=R)
    for leaf, ref in zip(leaves, want):
        _close(leaf.grad, ref)


def test_kernels_skip_autograd_under_inference_mode(dev):
    """Under inference_mode (the engine's) the wrappers launch without
    recording a graph, parameters requiring grad or not."""
    kernel, _, inputs = _grad_cases(dev)["deform_conv2d_bounded"]
    params = [t.clone().requires_grad_() for t in inputs]
    with torch.inference_mode():
        out = kernel(*params)
    assert out.grad_fn is None and not out.requires_grad


def test_kernels_refuse_float32(dev):
    """Float32 runs the kernels' float32 instances now; what they refuse
    with TypeError is any other dtype (float16) and operands of mixed
    dtypes, and weights packed in another dtype than the input's with
    ValueError."""
    from vfi_tpu_torch.ops.cuda import pack_conv2d

    h16 = dict(dtype=torch.float16, device=dev)
    x = torch.zeros(1, 8, 16, 16, **h16)
    w = torch.zeros(16, 16, 3, 3, device=dev)
    with pytest.raises(TypeError):
        conv_chain(x, [w], [None], (True,))
    with pytest.raises(TypeError):
        bounded_warp(torch.zeros(1, 8, 16, 3, **h16),
                     torch.zeros(1, 8, 16, 2, **h16))
    with pytest.raises(TypeError):
        conv2d(x, w)
    with pytest.raises(TypeError):
        bounded_warp(torch.zeros(1, 8, 16, 3, device=dev),
                     torch.zeros(1, 8, 16, 2, dtype=torch.bfloat16,
                                 device=dev))
    with pytest.raises(TypeError):
        deform_conv2d_bounded(x.float(), torch.zeros(
            1, 8, 16, 18, dtype=torch.bfloat16, device=dev), None, w, None, 1)
    with pytest.raises(ValueError):
        conv2d(x.float(), w, packed=pack_conv2d(w, None))


def test_packed_weights_match_packing_on_the_call(dev):
    from vfi_tpu_torch.ops.cuda import pack_conv_chain, pack_dcn

    gen = torch.Generator(device=dev).manual_seed(3)
    x = _rnd(gen, dev, 1, 13, 37, 64)
    ws = [torch.randn(27, 64, 3, 3, generator=gen, device=dev) / 24]
    bs = [torch.randn(27, generator=gen, device=dev) * 0.1]
    assert torch.equal(conv_chain(x, ws, bs, (False,),
                                  packed=pack_conv_chain(ws, bs)),
                       conv_chain(x, ws, bs, (False,)))
    off = _rnd(gen, dev, 1, 13, 37, 18)
    mask = torch.sigmoid(_rnd(gen, dev, 1, 13, 37, 9).float()).to(
        torch.bfloat16)
    w = torch.randn(64, 64, 3, 3, generator=gen, device=dev) / 24
    assert torch.equal(
        deform_conv2d_bounded(x, off, mask, w, None, 1,
                              packed=pack_dcn(w, None)),
        deform_conv2d_bounded(x, off, mask, w, None, 1))
    with pytest.raises(ValueError):
        conv_chain(x, ws, bs, (False,), packed=pack_dcn(w, None))
    with pytest.raises(ValueError):
        deform_conv2d_bounded(x, off, mask, w, None, 1,
                              packed=pack_dcn(w[:32], None))


@pytest.mark.parametrize("conv_kernel,chains", [("pallas", 8), ("xla", 0)])
def test_q12_engine_runs_the_kernels(dev, conv_kernel, chains):
    """The 67-channel reference topology (q12: no fuse_proj, R=2, cascade
    2, flow prior) on the card: per engine launch 3 DCN and 1 warp kernel
    launches, and 8 conv-chain launches under conv_kernel="pallas" (none
    under "xla"); close to the same engine through the plain versions."""
    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.utils.convert import load_params_npz

    ckpt = os.path.join(REPO, "artifacts", "emavfi_q12_best")
    params = load_params_npz(ckpt + ".npz")
    flow = load_params_npz(ckpt + ".flow.npz")
    kw = dict(flow_params=flow, dcn_max_offset=2, warp_max_flow=16,
              cascade_levels=2, conv_kernel=conv_kernel,
              device="cuda")
    rng = np.random.default_rng(6)
    f0 = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    f1 = np.roll(f0, (3, -4), axis=(1, 2))
    eng = FrameInterpolator(params, **kw)
    reset_launch_counts()
    got = eng.midpoints(f0, f1)
    torch.cuda.synchronize()
    assert launch_counts() == {"conv_chain": chains,
                               "deform_conv2d_bounded": 3, "bounded_warp": 1,
                               "conv2d": 0, "conv_chain_fused": 0}
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    ref = FrameInterpolator(params, use_kernels=False, **kw).midpoints(f0, f1)
    mse = (got - ref).pow(2).mean().item()
    assert mse == 0 or 10 * np.log10(1 / mse) >= 40.0


def test_server_runs_the_kernels_on_a_raw_request(dev):
    """A 2x64x96 raw request through the port's HTTP server over the qocc
    engine at the flagship settings with io_uint8 and the kernels on: one
    engine launch with 8 conv-chain, 3 DCN, 1 warp and 1 conv (the fuse
    projection) kernel launches, a uint8 midpoint within 40 dB of the
    plain-version engine's."""
    import urllib.request

    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.serve import (RAW_CONTENT_TYPE, InterpolationServer,
                                     encode_raw_body)
    from vfi_tpu_torch.utils.convert import load_params_npz

    ckpt = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
    params = load_params_npz(ckpt + ".npz")
    kw = dict(flow_params=load_params_npz(ckpt + ".flow.npz"), bf16=True,
              dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
              conv_kernel="pallas", io_uint8=True, device="cuda")
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    b = np.roll(a, (2, -3), axis=(0, 1))
    server = InterpolationServer(FrameInterpolator(params, **kw),
                                 port=0).start()
    try:
        reset_launch_counts()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/interpolate",
            data=encode_raw_body(a, b),
            headers={"Content-Type": RAW_CONTENT_TYPE})
        with urllib.request.urlopen(req, timeout=300) as r:
            status, data = r.status, r.read()
        counts = launch_counts()
        batches = server.batcher.stats.snapshot()["batches"]
    finally:
        server.shutdown()
    assert status == 200 and batches == 1
    assert counts == {"conv_chain": 8, "deform_conv2d_bounded": 3,
                      "bounded_warp": 1, "conv2d": 1, "conv_chain_fused": 0}
    got = np.frombuffer(data, np.uint8).reshape(64, 96, 3)
    ref = FrameInterpolator(params, use_kernels=False, **kw).midpoints(
        a[None], b[None])[0].cpu().numpy()
    mse = np.mean(((got.astype(np.float64) - ref) / 255.0) ** 2)
    assert mse == 0 or 10 * np.log10(1 / mse) >= 40.0


def test_recursive_runs_the_kernels_at_every_level(dev):
    """`recursive` at factor 3 on a 2x64x96 pair at the flagship settings
    (qocc, flow prior, cascade 2, R=1, warp bound 16, conv_kernel
    "pallas"): three engine launches, each with 8 conv-chain, 3 DCN, 1
    warp and 1 conv (the fuse projection) kernel launches; every inserted
    frame within 40 dB of the plain-version engine's."""
    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.utils.convert import load_params_npz

    ckpt = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
    params = load_params_npz(ckpt + ".npz")
    kw = dict(flow_params=load_params_npz(ckpt + ".flow.npz"), bf16=True,
              dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
              conv_kernel="pallas", device="cuda")
    rng = np.random.default_rng(8)
    f0 = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    f1 = np.roll(f0, (2, -3), axis=(1, 2))
    eng = FrameInterpolator(params, **kw)
    reset_launch_counts()
    got = eng.recursive(f0, f1, 3)
    torch.cuda.synchronize()
    assert launch_counts() == {"conv_chain": 24,
                               "deform_conv2d_bounded": 9, "bounded_warp": 3,
                               "conv2d": 3, "conv_chain_fused": 0}
    ref = FrameInterpolator(params, use_kernels=False, **kw).recursive(
        f0, f1, 3)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and torch.isfinite(g).all()
        mse = (g - r).pow(2).mean().item()
        assert mse == 0 or 10 * np.log10(1 / mse) >= 40.0


def test_train_step_runs_the_kernels_and_moves_their_forward(dev):
    """One kernel-route train step of a tiny joint tree (EMAVFI 16 wide,
    one block, R=1, warp bound 16, cascade 2, flow prior, bf16) at the
    qocc recipe's flags (remat, accum 2, occlusion, pyramid): each
    microbatch launches the DCN and the warp twice (remat), every gradient
    reaching a float32 leaf is float32 and finite, and the step moves the
    kernel-route forward as it moves the plain route's (no packed copy of
    the weights goes stale)."""
    from torch import nn

    from vfi_tpu_torch.losses import LossWeights
    from vfi_tpu_torch.models import EMAVFI, SimpleFlowNet
    from vfi_tpu_torch.ops.cuda import PLAIN
    from vfi_tpu_torch.train import create_train_state, make_train_step

    torch.manual_seed(0)
    kw = dict(mid_channels=16, num_blocks=1, dtype=torch.bfloat16,
              dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
              fuse_project=True)
    tree = nn.ModuleDict({"model": EMAVFI(**kw),
                          "flow": SimpleFlowNet(mid_channels=8, levels=2,
                                                dtype=torch.bfloat16)})
    with torch.no_grad():
        tree["model"].fusion_dcn0.offset_conv.weight.normal_(0, 0.05)
    tree.to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    f0 = torch.rand(4, 40, 48, 3, generator=gen, device=dev)
    f1 = torch.roll(f0, (1, 2), dims=(1, 2))
    batch = (f0, (f0 + f1) / 2, f1)
    plain = EMAVFI(**kw).to(dev)
    plain.ops = PLAIN

    def forward(model):
        with torch.no_grad():
            return model(f0, f1).float()

    before = forward(tree["model"])
    st = create_train_state(tree, 1e-2)
    step = make_train_step(None, 1, LossWeights(vgg=0.0), remat=True,
                           joint_flow=True, target_unit_range=True,
                           flow_prior=True, accum_steps=2,
                           flow_photo_pyramid=True,
                           flow_photo_occlusion=True)
    st.optimizer.zero_grad()
    reset_launch_counts()
    met = step(st, *batch)
    counts = launch_counts()
    assert counts["deform_conv2d_bounded"] == 4 and counts["bounded_warp"] == 4
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in met.values())
    for p in tree.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()
    after = forward(tree["model"])
    plain.load_state_dict(tree["model"].state_dict())
    ref = forward(plain)

    def db(a, b):
        return 10 * torch.log10(1 / (a - b).pow(2).mean()).item()

    assert db(after, ref) >= 40.0
    assert db(after, before) < db(after, ref) - 10.0


# ---------------------------------------------------------------------------
# The float32 instances.
F32_TOL = 2.0 ** -14
RELU3, RRN = (True, True, True), (True, True, False)


def _close_f32(got, ref, tol=F32_TOL):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float32
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def _f32(gen, dev, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device=dev) * scale


@pytest.mark.parametrize("hw", [(9, 7), (13, 37), (100, 300)])
@pytest.mark.parametrize("cin,cout,k,act", [
    (64, 64, 3, True), (128, 64, 3, True), (64, 27, 3, False),
    (64, 2, 3, False), (32, 3, 3, False), (64, 32, 1, False),
    (16, 128, 1, True), (64, 64, 5, True), (67, 5, 5, False),
    (24, 3, 7, True), (200, 40, 9, True), (3, 16, 3, True)])
def test_conv2d_kernel_f32(dev, hw, cin, cout, k, act):
    """The conv's float32 instance (3xTF32 on the tensor cores; 16 x 16 or
    8 x 16 tiles, resident or streamed weights) at every k, Cout below 8
    and off a multiple of 8, Cin off a multiple of 8, and its tile cut at
    every edge, B = 3."""
    assert conv2d_plan(-(-cin // 8) * 8, cout, k, itemsize=4)["core"] == (
        "tf32x3")
    gen = torch.Generator(device=dev).manual_seed(21)
    x = _f32(gen, dev, 3, *hw, cin)
    w = _f32(gen, dev, cout, cin, k, k, scale=(k * k * cin) ** -0.5)
    b = _f32(gen, dev, cout, scale=0.1)
    reset_launch_counts()
    got = conv2d(x, w, b, act)
    assert dict(conv2d.launches_by_shape) == {(cin, cout, k, *hw, "f32"): 1}
    _close_f32(got, conv2d_plain(x, w, b, act))
    _close_f32(conv2d(x, w, None, act), conv2d_plain(x, w, None, act))


@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (40, 72)])
@pytest.mark.parametrize("chans,acts", [
    ((64, 64, 64, 64), RELU3), ((128, 64, 64, 2), RRN), ((64, 27), (False,)),
    ((64, 64, 32, 3), RRN), ((67, 64, 32, 3), RRN), ((67, 27), (False,)),
    ((64, 64, 64, 64, 64), (True, False, True, True)),
    ((16, 27, 64, 16, 48), (True, True, True, False))])
def test_conv_chain_kernel_f32(dev, hw, chans, acts):
    """A float32 chain through `conv_chain` runs its layers (one float32
    conv launch a layer); `conv_chain_fused` runs the fused kernel's
    float32 instance (`vfi_conv_chain_f32`), held to the same plain
    version, and a chain of one layer still refuses it."""
    gen = torch.Generator(device=dev).manual_seed(22)
    x = _f32(gen, dev, 2, *hw, chans[0])
    ws = [_f32(gen, dev, co, ci, 3, 3, scale=(9 * ci) ** -0.5)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [_f32(gen, dev, co, scale=0.1) for co in chans[1:]]
    reset_launch_counts()
    got = conv_chain(x, ws, bs, acts)
    assert dict(conv_chain.launches_by_shape) == {(chans, *hw, "f32"): 1}
    assert conv_chain_fused.launches == 0
    ref = conv_chain_plain(x, ws, bs, acts)
    _close_f32(got, ref)
    if len(ws) > 1:
        reset_launch_counts()
        _close_f32(conv_chain_fused(x, ws, bs, acts), ref)
        assert dict(conv_chain_fused.launches_by_shape) == {
            (chans, *hw, "f32"): 1}
        assert conv_chain.launches == 0
    else:
        with pytest.raises(ValueError, match="no fused plan"):
            conv_chain_fused(x, ws, bs, acts)


def _dcn_case_f32(dev, seed, b, hw, cin, cout, R, with_mask=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _f32(gen, dev, b, *hw, cin)
    off = _f32(gen, dev, b, *hw, 18, scale=0.8 * max(R, 1))
    mask = (torch.sigmoid(_f32(gen, dev, b, *hw, 9, scale=2.0))
            if with_mask else None)
    w = _f32(gen, dev, cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    return x, off, mask, w, _f32(gen, dev, cout, scale=0.1)


# Every branch of the float32 plan: the tile design on 8 x 16 tiles (slabs
# of all Cin8 and in passes; its warp pairs' halves of Cout16 from 8 to 56
# channels, odd and even counts of n-fragments), the stream design in one
# chunk and several (a ragged last chunk, 8-channel chunks at R = 28 and
# 35; n-fragments in groups of 4 past Cout16 = 64), Cout below 16 and off
# a multiple of 8, Cout16 80, 96 and 112 on both designs, H and W below
# one tile, ragged edges, (100, 300) at B = 3 (more tiles than the
# persistent grid).
@pytest.mark.parametrize("hw", [(5, 7), (13, 37), (100, 300)])
@pytest.mark.parametrize("cin,cout,R,design,tile", [
    (64, 64, 1, "tile", "8x16"), (16, 32, 2, "tile", "8x16"),
    (3, 24, 2, "tile", "8x16"), (64, 27, 0, "tile", "8x16"),
    (67, 5, 2, "tile", "8x16"), (67, 67, 2, "stream", "8x16"),
    (67, 67, 8, "stream", "8x16"), (128, 128, 4, "stream", "8x16"),
    (80, 67, 4, "stream", "8x16"), (128, 8, 28, "stream", "4x16"),
    (128, 128, 35, "stream", "4x16"), (16, 80, 1, "tile", "8x16"),
    (16, 96, 1, "tile", "8x16"), (16, 112, 1, "tile", "8x16"),
    (64, 80, 4, "stream", "8x16"), (64, 96, 4, "stream", "8x16"),
    (64, 112, 4, "stream", "8x16")])
def test_deform_conv2d_bounded_f32_plans(dev, hw, cin, cout, R, design,
                                         tile):
    plan = dcn_plan(cin, cout, R, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin, 4)
    assert (plan["design"], plan["tile"], plan["core"]) == (design, tile,
                                                            "tf32x3")
    x, off, mask, w, b = _dcn_case_f32(dev, 23, 3, hw, cin, cout, R)
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert dict(deform_conv2d_bounded.launches_by_shape) == {
        (cin, cout, *hw, R, "f32"): 1}
    _close_f32(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("cin,R", [(64, 1), (128, 4)])
def test_deform_conv2d_bounded_f32_without_a_mask_and_off_alignment(dev, cin,
                                                                    R):
    """No mask (weight 1), on both designs; an offset view off its 8-byte
    alignment is copied to an aligned one first."""
    x, off, _, w, b = _dcn_case_f32(dev, 24, 2, (19, 45), cin, cin, R)
    ref = deform_conv2d_bounded_plain(x, off, None, w, b, R)
    _close_f32(deform_conv2d_bounded(x, off, None, w, b, R), ref)
    store = torch.empty(off.numel() + 1, device=dev)
    store[1:] = off.reshape(-1)
    view = store[1:].view(off.shape)
    assert view.data_ptr() % 8
    _close_f32(deform_conv2d_bounded(x, view, None, w, b, R), ref)


# The 3xTF32 tiling's edges: Cin 1, 3 and 67 (padded to 8 by the wrapper:
# one k-step, or a ragged last chunk), Cout 2, 3 and 27 (one n8 fragment
# partly used, an odd Cout's scalar stores), k = 9 at Cout = 128 (8 x 16
# tiles, weights streamed in tap groups), and k = 9 at Cin 16 and 24 (past
# F32_FLUSH_K columns: resident weights in 8-channel chunks, each step
# flushed).
@pytest.mark.parametrize("hw", [(13, 37), (40, 72)])
@pytest.mark.parametrize("cin,cout,k,act", [
    (1, 16, 3, True), (3, 2, 3, False), (67, 3, 3, False), (67, 27, 3, False),
    (1, 27, 5, True), (8, 128, 9, True), (67, 128, 9, False),
    (16, 16, 9, True), (24, 16, 9, False)])
def test_conv2d_kernel_f32_tiling_edges(dev, hw, cin, cout, k, act):
    cin8 = -(-cin // 8) * 8
    plan = conv2d_plan(cin8, cout, k, itemsize=4)
    assert plan["core"] == "tf32x3"
    assert plan["flush"] == (k * k * cin8 > 1152)
    rows = (8 if cout > 64 else 16) // (2 if plan["flush"] else 1)
    assert plan["tile"] == f"{rows}x16"
    gen = torch.Generator(device=dev).manual_seed(26)
    x = _f32(gen, dev, 2, *hw, cin)
    w = _f32(gen, dev, cout, cin, k, k, scale=(k * k * cin) ** -0.5)
    b = _f32(gen, dev, cout, scale=0.1)
    reset_launch_counts()
    _close_f32(conv2d(x, w, b, act), conv2d_plain(x, w, b, act))
    assert dict(conv2d.launches_by_shape) == {(cin, cout, k, *hw, "f32"): 1}


# The DCN's: Cin 1, 3, 67; Cout 2, 3, 27; R = 34 and 35; Cin past 128 on
# both designs (128 and 136 on the tile design, 256 streamed), and 1200 (K
# = 10,800: 136-channel chunks, each step's sums flushed) within 2^-14.
@pytest.mark.parametrize("hw", [(13, 37), (40, 72)])
@pytest.mark.parametrize("cin,cout,R,design", [
    (1, 16, 1, "tile"), (3, 2, 1, "tile"), (67, 3, 2, "tile"),
    (64, 27, 1, "tile"), (67, 27, 8, "stream"), (128, 3, 35, "stream"),
    (128, 2, 34, "stream"), (128, 16, 0, "tile"), (136, 16, 0, "tile"),
    (256, 64, 1, "stream"), (1200, 16, 1, "stream")])
def test_deform_conv2d_bounded_f32_tiling_edges(dev, hw, cin, cout, R,
                                                design):
    plan = dcn_plan(cin, cout, R, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin, 4)
    assert (plan["design"], plan["core"]) == (design, "tf32x3")
    x, off, mask, w, b = _dcn_case_f32(dev, 27, 2, hw, cin, cout, R)
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert dict(deform_conv2d_bounded.launches_by_shape) == {
        (cin, cout, *hw, R, "f32"): 1}
    _close_f32(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("hw", [(7, 9), (13, 37), (40, 17), (176, 1000)])
@pytest.mark.parametrize("c", [1, 3, 4, 8, 64, 67, 6])
def test_bounded_warp_f32_is_bit_exact(dev, c, hw, aligned):
    """The float32 instances (RGB for C <= 4; wide16, groups of 4
    channels, where C % 4 == 0 and the image is 16-byte aligned; wide2b
    otherwise) equal the plain version bit for bit, the flow (C <= 4) or
    the image (wider) on its vector alignment and off it."""
    gen = torch.Generator(device=dev).manual_seed(25)
    img = torch.rand(3, *hw, c, generator=gen, device=dev)
    flow = _f32(gen, dev, 3, *hw, 2, scale=12.0)
    if not aligned:
        t = flow if c <= 4 else img
        store = torch.empty(t.numel() + 1, device=dev)
        store[1:] = t.reshape(-1)
        t = store[1:].view(t.shape)
        flow, img = (t, img) if c <= 4 else (flow, t)
    reset_launch_counts()
    got = bounded_warp(img, flow, 16)
    assert dict(bounded_warp.launches_by_shape) == {(c, *hw, 16, "f32"): 1}
    torch.cuda.synchronize()
    assert torch.equal(got, bounded_warp_plain(img, flow, 16))


@pytest.mark.parametrize("name", [
    "conv2d", "conv_chain", "deform_conv2d_bounded",
    "deform_conv2d_bounded_no_mask", "deform_conv2d_bounded_stream",
    "bounded_warp", "bounded_warp_wide"])
def test_gradients_through_the_f32_kernels_match_the_plain_versions(dev,
                                                                    name):
    """The gradient cases above with float32 activations: the float32
    instances launch, and every gradient (float32) matches the plain
    version's."""
    kernel, plain, inputs = _grad_cases(dev)[name]
    inputs = [None if t is None else t.float() for t in inputs]
    reset_launch_counts()
    out, gk = _grads(kernel, inputs)
    assert out.grad_fn is not None and out.dtype == torch.float32
    assert sum(launch_counts().values()) == 1
    _, gp = _grads(plain, inputs)
    for a, b in zip(gk, gp):
        if b is not None:
            _close_f32(a, b)


def test_f32_engine_runs_the_f32_kernels(dev):
    """The flagship settings with bf16=False (qocc, flow prior, cascade 2,
    R=1, warp bound 16, conv_kernel "pallas") on a 2x64x96 pair: 8 / 3 / 1
    launches, every one a float32 instance, within 2**-12 of the float32
    plain-version engine."""
    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.ops.cuda import WRAPPERS
    from vfi_tpu_torch.utils.convert import load_params_npz

    ckpt = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
    kw = dict(flow_params=load_params_npz(ckpt + ".flow.npz"), bf16=False,
              dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
              conv_kernel="pallas", device="cuda:0")
    params = load_params_npz(ckpt + ".npz")
    rng = np.random.default_rng(26)
    f0 = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    f1 = np.roll(f0, (2, -3), axis=(1, 2))
    reset_launch_counts()
    got = FrameInterpolator(params, **kw).midpoints(f0, f1)
    torch.cuda.synchronize()
    assert launch_counts() == {"conv_chain": 8, "deform_conv2d_bounded": 3,
                               "bounded_warp": 1, "conv2d": 0,
                               "conv_chain_fused": 0}
    assert all(key[-1] == "f32" for fn in WRAPPERS
               for key in fn.launches_by_shape)
    ref = FrameInterpolator(params, use_kernels=False, **kw).midpoints(f0,
                                                                       f1)
    assert (got - ref).abs().max().item() <= 2.0 ** -12


def test_f32_train_step_runs_the_f32_kernels(dev):
    """One kernel-route train step of a tiny joint tree in float32 (bf16
    false, use_pallas) at the qocc recipe's flags: each microbatch launches
    the float32 DCN and warp twice (remat); the loss and gradients match
    the plain route's."""
    from torch import nn

    from vfi_tpu_torch.losses import LossWeights
    from vfi_tpu_torch.models import EMAVFI, SimpleFlowNet
    from vfi_tpu_torch.ops.cuda import PLAIN
    from vfi_tpu_torch.train import create_train_state, make_train_step

    torch.manual_seed(0)
    kw = dict(mid_channels=16, num_blocks=1, dcn_max_offset=1,
              warp_max_flow=16, cascade_levels=2, fuse_project=True)
    tree = nn.ModuleDict({"model": EMAVFI(**kw),
                          "flow": SimpleFlowNet(mid_channels=8, levels=2)})
    with torch.no_grad():
        tree["model"].fusion_dcn0.offset_conv.weight.normal_(0, 0.05)
    tree.to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    f0 = torch.rand(4, 40, 48, 3, generator=gen, device=dev)
    f1 = torch.roll(f0, (1, 2), dims=(1, 2))
    batch = (f0, (f0 + f1) / 2, f1)
    out = {}
    for route in ("kernel", "plain"):
        t = copy.deepcopy(tree)
        if route == "plain":
            t["model"].ops = PLAIN
        step = make_train_step(None, 1, LossWeights(vgg=0.0), remat=True,
                               joint_flow=True, target_unit_range=True,
                               flow_prior=True, accum_steps=2,
                               flow_photo_pyramid=True,
                               flow_photo_occlusion=True)
        reset_launch_counts()
        met = step(create_train_state(t, 0.0), *batch)
        torch.cuda.synchronize()
        out[route] = (float(met["loss"]), launch_counts(),
                      [key[-1] for fn in (deform_conv2d_bounded, bounded_warp)
                       for key in fn.launches_by_shape],
                      torch.cat([p.grad.flatten() for p in t.parameters()
                                 if p.grad is not None]))
    (lk, nk, tags, gk), (lp, _, _, gp) = out["kernel"], out["plain"]
    assert nk["deform_conv2d_bounded"] == 4 and nk["bounded_warp"] == 4
    assert tags and set(tags) == {"f32"}
    assert gk.dtype == torch.float32 and torch.isfinite(gk).all()
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    assert torch.nn.functional.cosine_similarity(gk, gp, dim=0) >= 0.9999


def _random_engines(dev, config, bf16, **kw):
    """Two engines over one random tree of the configuration's topology
    (qocc: the fuse projection, R=1; q12: 67-wide DCNs, R=2; both with
    the flow prior, cascade 2, warp bound 16, conv_kernel "pallas"), on
    64x96 frames in launches of 4 pairs: the first with its CUDA graphs,
    the second with no graph key (every launch eager), as the reference."""
    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.models import EMAVFI, SimpleFlowNet
    from vfi_tpu_torch.utils.convert import params_to_jax

    fuse, radius = {"qocc": (True, 1), "q12": (False, 2)}[config]
    torch.manual_seed(0)
    model = EMAVFI(mid_channels=64, num_blocks=3, fuse_project=fuse,
                   dcn_max_offset=radius, warp_max_flow=16)
    with torch.no_grad():
        for i in range(3):
            getattr(model, f"fusion_dcn{i}").offset_conv.weight.normal_(
                0, 0.02)
    params = params_to_jax(model.state_dict())
    flow = params_to_jax(SimpleFlowNet(mid_channels=32,
                                       levels=3).state_dict())
    kw = dict(flow_params=flow, bf16=bf16, io_uint8=bf16,
              dcn_max_offset=radius, warp_max_flow=16, cascade_levels=2,
              conv_kernel="pallas", device=dev,
              max_px_per_launch=4 * 64 * 96, **kw)
    graphs, eager = FrameInterpolator(params, **kw), \
        FrameInterpolator(params, **kw)
    eager._graph_key = lambda *args: None
    return graphs, eager


def _pairs(seed, b, bf16):
    rng = np.random.default_rng(seed)
    f0 = rng.integers(0, 256, (b, 64, 96, 3), dtype=np.uint8)
    f1 = np.roll(f0, (2, -3), axis=(1, 2))
    if not bf16:
        f0, f1 = (x.astype(np.float32) / 255 for x in (f0, f1))
    return torch.from_numpy(f0).pin_memory(), torch.from_numpy(f1).pin_memory()


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("config", ["qocc", "q12"])
def test_graph_replays_equal_the_eager_launches(dev, config, bf16):
    """Calls of 8 pairs (two launches of 4) replay the launch's graph from
    the second launch on, across new frames after the capture, and equal
    the eager engine's midpoints bit for bit. The wrappers count a kernel
    where they launch it: once in an eager launch, twice in a captured
    one (its eager run and its recording), never in a replay; the device
    trace of a replayed call holds the eager call's port kernels, name
    for name. The sequence route takes the same graph."""
    from torch.profiler import ProfilerActivity, profile

    from vfi_tpu_torch.utils.profiling import port_kernel_counts

    graphs, eager = _random_engines(dev, config, bf16)
    calls = [_pairs(s, 8, bf16) for s in (1, 2, 1)]
    for i, (f0, f1) in enumerate(calls):
        reset_launch_counts()
        want = eager.midpoints(f0, f1)
        assert launch_counts()["conv_chain"] == 16
        reset_launch_counts()
        got = graphs.midpoints(f0, f1)
        torch.cuda.synchronize()
        assert launch_counts()["conv_chain"] == (24 if i == 0 else 0)
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert graphs.graph_stats == {"captured": 1, "replayed": 4, "eager": 1,
                                  "evicted": 0}
    frames = torch.cat([calls[1][0][:3], calls[1][1][2:3]])   # 3 pairs
    want = eager.midpoints_sequence(frames)
    for _ in range(3):
        assert torch.equal(graphs.midpoints_sequence(frames), want)
    assert graphs.graph_stats == {"captured": 2, "replayed": 5, "eager": 2,
                                  "evicted": 0}
    assert torch.equal(graphs.midpoints(frames[:-1], frames[1:]), want)
    ran = {}
    for name, eng in (("eager", eager), ("replayed", graphs)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.midpoints(*calls[1])
            torch.cuda.synchronize()
        ran[name] = port_kernel_counts(prof.events())
    assert graphs.graph_stats["replayed"] == 8
    assert sum(ran["eager"].values()) >= 16 + 6 + 2
    assert ran["replayed"] == ran["eager"]


def test_graph_recaptured_after_eviction_is_exact(dev, monkeypatch):
    """With room for one key, alternating batch sizes evict and recapture:
    each capture's midpoints equal the eager engine's."""
    from vfi_tpu_torch.infer import pair

    graphs, eager = _random_engines(dev, "qocc", True)
    monkeypatch.setattr(pair, "GRAPH_KEYS", 1)
    for b in (2, 2, 3, 3, 2, 2, 2):
        f0, f1 = _pairs(b, b, True)
        assert torch.equal(graphs.midpoints(f0, f1), eager.midpoints(f0, f1))
    assert graphs.graph_stats == {"captured": 3, "replayed": 1, "eager": 3,
                                  "evicted": 2}


def test_graph_captured_in_another_thread_is_exact(dev):
    """A key first run on one thread (a server's warm-up) and then on a
    worker thread, which has made no cuDNN or cuBLAS handle yet: the
    worker captures and replays, and every launch equals the eager
    engine's."""
    import threading

    graphs, eager = _random_engines(dev, "qocc", True)
    f0, f1 = _pairs(9, 4, True)
    want = eager.midpoints(f0, f1)
    got = [graphs.midpoints(f0, f1)]

    def worker():
        for _ in range(2):
            got.append(graphs.midpoints(f0, f1))

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and len(got) == 3
    assert all(torch.equal(g, want) for g in got)
    assert graphs.graph_stats == {"captured": 1, "replayed": 1, "eager": 1,
                                  "evicted": 0}


def test_a_failed_graph_capture_runs_eager_and_takes_a_new_pool(dev,
                                                             monkeypatch):
    """A launch that synchronises the card while it is being captured:
    the capture fails with a warning, that launch and the key's later
    ones run eager and equal the eager engine's; another key then
    captures on a new pool."""
    graphs, eager = _random_engines(dev, "qocc", True)
    body = graphs._launch_body

    def syncing(*args):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return body(*args)

    monkeypatch.setattr(graphs, "_launch_body", syncing)
    f0, f1 = _pairs(10, 2, True)
    want = eager.midpoints(f0, f1)
    assert torch.equal(graphs.midpoints(f0, f1), want)
    with pytest.warns(UserWarning, match="capture"):
        assert torch.equal(graphs.midpoints(f0, f1), want)
    assert torch.equal(graphs.midpoints(f0, f1), want)
    assert graphs.graph_stats == {"captured": 0, "replayed": 0, "eager": 3,
                                  "evicted": 0}
    monkeypatch.setattr(graphs, "_launch_body", body)
    f0, f1 = _pairs(11, 3, True)
    want = eager.midpoints(f0, f1)
    for _ in range(3):
        assert torch.equal(graphs.midpoints(f0, f1), want)
    assert graphs.graph_stats["captured"] == 1
    assert graphs.graph_stats["replayed"] == 1
