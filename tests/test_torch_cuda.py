"""The port's CUDA kernels vs their plain versions on the card, at small
shapes with ragged edges (the main paths' full-size shapes run in
chip_smoke.py): the DCN under v4's contract (C in {64, 67} x R 1..4, with
and without a mask) and, on the stream design, at widths and radii no
tile plan holds, the chains with a 67-wide first layer (one layer through
the conv kernel), the single conv at k 1..9 with its tile cut at every edge,
the warp at C=3 and wide C, gradients through every kernel wrapper
against those through its plain version, q12 (the 67-channel
topology) through the engine with both conv_kernel settings, and the
flagship engine (io_uint8) behind the HTTP server. Needs an
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
chip_smoke.py."""

import os

import numpy as np
import pytest
import torch

from vfi_tpu_torch.ops.cuda import (bounded_warp, bounded_warp_plain,
                                    chain_plan, conv2d, conv2d_plain,
                                    conv_chain,
                                    conv_chain_plain, dcn_plan,
                                    deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain,
                                    launch_counts, reset_launch_counts)

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


@pytest.mark.parametrize("route", [None, "fused", "layers"])
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
def test_conv_chain_kernel(dev, hw, chans, acts, route):
    """Every chain through the plan's route and through each route forced
    (one layer runs the conv kernel, csrc/conv2d.cu, and refuses "fused");
    one launch counted either way, by route in `launches_by_plan`."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _rnd(gen, dev, 2, *hw, chans[0])
    ws = [torch.randn(co, ci, 3, 3, generator=gen, device=dev) / (9 * ci) ** .5
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [torch.randn(co, generator=gen, device=dev) * 0.1 for co in chans[1:]]
    reset_launch_counts()
    if route == "fused" and len(ws) == 1:
        with pytest.raises(ValueError, match="fused"):
            conv_chain(x, ws, bs, acts, route=route)
        return
    got = conv_chain(x, ws, bs, acts, route=route)
    assert launch_counts()["conv_chain"] == 1
    assert launch_counts()["conv2d"] == 0
    want = route or chain_plan(chans, acts, 2, *hw,
                               torch.cuda.get_device_properties(dev)
                               .shared_memory_per_block_optin)["route"]
    assert dict(conv_chain.launches_by_plan) == {(want, chans, *hw): 1}
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
            lambda x, *p: conv_chain(x, p[:2], p[2:], (True, False),
                                     route="fused"),
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


def test_kernels_skip_autograd_under_inference_mode(dev):
    """Under inference_mode (the engine's) the wrappers launch without
    recording a graph, parameters requiring grad or not."""
    kernel, _, inputs = _grad_cases(dev)["deform_conv2d_bounded"]
    params = [t.clone().requires_grad_() for t in inputs]
    with torch.inference_mode():
        out = kernel(*params)
    assert out.grad_fn is None and not out.requires_grad


def test_kernels_refuse_float32(dev):
    x = torch.zeros(1, 8, 16, 16, device=dev)
    with pytest.raises(TypeError):
        conv_chain(x, [torch.zeros(16, 16, 3, 3, device=dev)], [None], (True,))
    with pytest.raises(TypeError):
        bounded_warp(torch.zeros(1, 8, 16, 3, device=dev),
                     torch.zeros(1, 8, 16, 2, device=dev))
    with pytest.raises(TypeError):
        conv2d(x, torch.zeros(16, 16, 3, 3, device=dev))


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
                               "conv2d": 0}
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    ref = FrameInterpolator(params, use_kernels=False, **kw).midpoints(f0, f1)
    mse = (got - ref).pow(2).mean().item()
    assert mse == 0 or 10 * np.log10(1 / mse) >= 40.0


def test_server_runs_the_kernels_on_a_raw_request(dev):
    """A 2x64x96 raw request through the port's HTTP server over the qocc
    engine at the flagship settings with io_uint8 and the kernels on: one
    engine launch with 8 conv-chain, 3 DCN and 1 warp kernel launches,
    a uint8 midpoint within 40 dB of the plain-version engine's."""
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
                      "bounded_warp": 1, "conv2d": 0}
    got = np.frombuffer(data, np.uint8).reshape(64, 96, 3)
    ref = FrameInterpolator(params, use_kernels=False, **kw).midpoints(
        a[None], b[None])[0].cpu().numpy()
    mse = np.mean(((got.astype(np.float64) - ref) / 255.0) ** 2)
    assert mse == 0 or 10 * np.log10(1 / mse) >= 40.0


def test_recursive_runs_the_kernels_at_every_level(dev):
    """`recursive` at factor 3 on a 2x64x96 pair at the flagship settings
    (qocc, flow prior, cascade 2, R=1, warp bound 16, conv_kernel
    "pallas"): three engine launches, each with 8 conv-chain, 3 DCN and 1
    warp kernel launches; every inserted frame within 40 dB of the
    plain-version engine's."""
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
                               "conv2d": 0}
    ref = FrameInterpolator(params, use_kernels=False, **kw).recursive(
        f0, f1, 3)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and torch.isfinite(g).all()
        mse = (g - r).pow(2).mean().item()
        assert mse == 0 or 10 * np.log10(1 / mse) >= 40.0
