"""The DCN kernel's plan (`vfi_tpu_torch.ops.cuda.dcn_plan`, pure Python,
no card) and the sampling wrappers' launch checks on the CPU.

`dcn_plan` picks the design of `csrc/dcn_bounded.cu` a launch runs ("tile":
the weight-stationary GEMM on 16 x 16 output tiles with two input buffers
or one, or 8 x 16 tiles with one; "stream" where no tile plan fits: the
same GEMM core with the weights streamed a tap at a time and the input in
channel chunks, on 8 x 16 or 4 x 16 tiles) and its shared memory.
Every DCN shape the card runs (chip_smoke.py's kernel rows and
tests/test_torch_cuda.py) must fit an H100's 232,448 bytes a block; the
search falls back in a stated order, holds every shape up to R = 35 and
refuses what nothing holds. The C entry point (`vfi_dcn_bounded_bf16`)
checks a plan's regions against the same sums (`_entry_accepts`).

The launch checks (`_cuda_checks`) are reached on the card only; here a
stand-in with a CUDA tensor's attributes drives them, and a tensor on the
`meta` device drives the wrappers' device refusal: both must raise the
errors the wrappers have always raised.
"""

import pytest
import torch

from vfi_tpu_torch.ops.cuda import (bounded_warp, build, dcn_plan,
                                    deform_conv2d_bounded)
from vfi_tpu_torch.ops.cuda.conv import H100_SMEM_PER_BLOCK, ROW_PAD
from vfi_tpu_torch.ops.cuda.sampling import (DCN_TILE_W, _cuda_checks,
                                             _dcn_chunks, _dcn_xu)


def _pad(c, m):
    return -(-c // m) * m


# (cin, cout, R, design) of every DCN launch the card makes: chip_smoke.py's
# rows (qocc C=64 R=1; q12 C=67 R=2, and at R=8 in its q12_r8 request; C=67
# R=4 and 8, C=128 R=4 and 8; the grad phase's C=128 R=4) and the card
# tests' shapes.
CARD_SHAPES = [
    (64, 64, 1, "tile"), (67, 67, 2, "tile"), (67, 67, 4, "tile"),
    (67, 67, 8, "stream"), (128, 128, 4, "stream"), (128, 128, 8, "stream"),
    (16, 32, 2, "tile"), (32, 16, 3, "tile"), (64, 128, 1, "tile"),
    (67, 5, 2, "tile"), (3, 24, 2, "tile"), (80, 67, 4, "tile"),
    (64, 64, 3, "tile"), (64, 64, 5, "tile"), (64, 64, 8, "tile"),
    (128, 128, 6, "stream"), (67, 67, 20, "stream"), (64, 27, 0, "tile"),
    (64, 67, 4, "tile"), (64, 64, 2, "tile"), (67, 67, 1, "tile"),
    (67, 67, 3, "tile"), (128, 128, 1, "stream"), (128, 128, 35, "stream"),
    (64, 64, 9, "stream"), (67, 67, 7, "stream"), (128, 27, 9, "stream"),
    (67, 128, 12, "stream"), (128, 67, 3, "stream"), (128, 8, 10, "stream"),
    (128, 27, 6, "stream"), (128, 64, 1, "stream"), (128, 8, 28, "stream"),
    (128, 8, 29, "stream"), (128, 128, 0, "stream")]


def _entry_accepts(p, cin, cout, R):
    """The regions the C entry (`vfi_dcn_bounded_bf16`) recomputes from a
    plan and the checks it makes before a launch: a plan the entry would
    refuse fails here."""
    cin8, cin16, cout16 = _pad(cin, 8), _pad(cin, 16), _pad(cout, 16)
    rows, chans, nbuf, xu = p["rows"], p["chans"], p["nbuf"], p["xu"]
    tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
    s_bytes = 2 * rows * DCN_TILE_W * (chans + ROW_PAD)
    ok = (16 <= chans <= cin16 and chans % 16 == 0 and nbuf in (1, 2)
          and p["x_bytes"] % 128 == 0 and p["x_bytes"] >= 16 * tpx * xu)
    if p["design"] == "tile":
        w_bytes = 2 * 9 * cin16 * (cout16 + ROW_PAD)
        return (ok and rows in (8, 16) and xu == _dcn_xu(cin8)
                and p["smem_bytes"] >= w_bytes + nbuf * p["x_bytes"] + s_bytes)
    ws_bytes = 2 * chans * (cout16 + ROW_PAD)
    return (ok and rows in (4, 8) and nbuf == 1
            and xu >= min(chans, cin8) // 8
            and p["smem_bytes"] >= 2 * ws_bytes + nbuf * p["x_bytes"]
            + s_bytes)


@pytest.mark.parametrize("cin,cout,R,design", CARD_SHAPES)
def test_dcn_plan_fits_every_shape_the_card_runs(cin, cout, R, design):
    p = dcn_plan(cin, cout, R)
    assert p["design"] == design
    assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
    cin16, cout16 = _pad(cin, 16), _pad(cout, 16)
    if design == "tile":
        rows = p["rows"]
        tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
        assert p["tile"] == f"{rows}x{DCN_TILE_W}" and rows in (8, 16)
        assert p["chans"] % 16 == 0 and 16 <= p["chans"] <= cin16
        assert p["passes"] == -(-cin16 // p["chans"])
        assert p["x_bytes"] % 128 == 0
        assert p["x_bytes"] >= tpx * _dcn_xu(_pad(cin, 8)) * 16
        assert p["w_bytes"] == 9 * cin16 * (cout16 + ROW_PAD) * 2
        assert p["s_bytes"] == rows * DCN_TILE_W * (p["chans"] + ROW_PAD) * 2
        assert p["smem_bytes"] == (p["w_bytes"] + p["nbuf"] * p["x_bytes"]
                                   + p["s_bytes"])
    else:
        rows, chans, xu = p["rows"], p["chans"], p["xu"]
        tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
        assert p["tile"] == f"{rows}x{DCN_TILE_W}" and rows in (8, 4)
        assert chans in _dcn_chunks(cin16)
        assert p["chunks"] == -(-cin16 // chans)
        pieces = min(chans, _pad(cin, 8)) // 8
        assert xu in (pieces, _dcn_xu(pieces * 8))
        assert p["x_bytes"] == -(-tpx * xu * 16 // 128) * 128
        assert p["w_bytes"] == 2 * chans * (cout16 + ROW_PAD) * 2
        assert p["s_bytes"] == rows * DCN_TILE_W * (chans + ROW_PAD) * 2
        assert p["smem_bytes"] == (p["w_bytes"] + p["nbuf"] * p["x_bytes"]
                                   + p["s_bytes"])
    assert _entry_accepts(p, cin, cout, R)


@pytest.mark.parametrize("cin,cout,R,want", [
    (64, 64, 1, ("tile", "16x16", 2)), (64, 64, 3, ("tile", "16x16", 1)),
    (67, 67, 2, ("tile", "16x16", 1)), (64, 64, 5, ("tile", "16x16", 1)),
    (64, 64, 8, ("tile", "8x16", 1)), (67, 67, 4, ("tile", "8x16", 1)),
    (128, 128, 1, ("stream", "8x16", 1, 1)),
    (128, 128, 4, ("stream", "8x16", 1, 1)),
    (128, 128, 8, ("stream", "8x16", 1, 2)),
    (67, 67, 20, ("stream", "8x16", 1, 5)),
    (128, 27, 6, ("stream", "8x16", 1, 2)),
    (128, 8, 28, ("stream", "4x16", 1, 8))])
def test_dcn_plan_falls_back_in_order(cin, cout, R, want):
    """16 x 16 tiles with two buffers, then with one, then 8 x 16 tiles
    with one; where no tile plan holds the resident weights and a buffer,
    the stream design: 8 x 16 tiles, then 4 x 16, each with the widest
    chunk and one input buffer (want: design, tile, buffers, chunks)."""
    p = dcn_plan(cin, cout, R)
    if want[0] == "tile":
        assert (p["design"], p["tile"], p["nbuf"]) == want
    else:
        assert (p["design"], p["tile"], p["nbuf"], p["chunks"]) == want


@pytest.mark.parametrize("cin,cout,R,want", [
    (128, 128, 35, ("4x16", 16, 8, 2, 225792)),
    (8, 8, 0, ("16x16", 16, 1, 1, 29696)),
    (128, 128, 0, ("8x16", 128, 1, 17, 153472)),
    (8, 128, 35, ("16x16", 16, 1, 1, 175360))])
def test_dcn_plan_byte_sums_at_the_extremes(cin, cout, R, want):
    """The plan's regions at the contract's corners, as the C entry sums
    them (want: tile, chunk or slab channels, chunks or passes, pixel
    stride in 16-byte units, shared-memory bytes). At C=128 R=35 only a
    4 x 16 tile in 16-channel chunks with unpadded pixels fits; C=8 R=0
    runs the tile design, C=128 R=0 the stream design in one chunk; an
    8-channel input at R=35 still fits the tile design, one 16-byte piece
    a pixel."""
    p = dcn_plan(cin, cout, R)
    n = p["chunks"] if p["design"] == "stream" else p["passes"]
    assert (p["tile"], p["chans"], n, p["xu"], p["smem_bytes"]) == want
    assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
    assert _entry_accepts(p, cin, cout, R)
    tpx = (p["rows"] + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
    assert p["x_bytes"] == -(-tpx * p["xu"] * 16 // 128) * 128


@pytest.mark.parametrize("cin,crossover", [(64, 9), (67, 7), (128, 0)])
def test_dcn_plan_crossover_to_the_stream_design(cin, crossover):
    """C -> C runs the tile design below the crossover R and the stream
    design from it to R = 35: C = 64 from R = 9, C = 67 from R = 7, C = 128
    at every R. No strip design is left."""
    designs = [dcn_plan(cin, cin, R)["design"] for R in range(36)]
    assert designs == ["tile"] * crossover + ["stream"] * (36 - crossover)


def test_dcn_plan_holds_every_shape_up_to_r35():
    """Every Cin <= 128 (in 8-channel pieces), Cout <= 128 (in 16-channel
    fragments) and R <= 35 has a plan within an H100's shared memory that
    the C entry accepts: the contract of the strip design this one
    replaced, whose smallest plan (16 pixels of one row, 16-channel
    chunks) held R <= 35 at any Cout."""
    for cin in range(8, 129, 8):
        for cout in range(16, 129, 16):
            for R in range(36):
                p = dcn_plan(cin, cout, R)
                assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
                assert _entry_accepts(p, cin, cout, R), (cin, cout, R)


def test_stream_chunks_are_the_fewest_equal_splits():
    assert _dcn_chunks(128) == [128, 64, 48, 32, 16]
    assert _dcn_chunks(80) == [80, 48, 32, 16]
    assert _dcn_chunks(16) == [16]


@pytest.mark.parametrize("cout16", range(16, 129, 16))
def test_two_small_buffers_fit_nothing_one_large_buffer_does_not(cout16):
    """The plan tries no 8 x 16 tile with two buffers: within an H100's
    232,448 bytes, wherever such a plan (resident weights, two buffers, a
    16-channel slab) fits, a 16 x 16 tile with one buffer and a 16-channel
    slab fits too, for every Cin up to 128 and R up to 35."""
    def smem(cin8, rows, nbuf, R):
        tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
        x = -(-tpx * _dcn_xu(cin8) * 16 // 128) * 128
        w = 9 * _pad(cin8, 16) * (cout16 + ROW_PAD) * 2
        return w + nbuf * x + rows * DCN_TILE_W * (16 + ROW_PAD) * 2
    for cin8 in range(8, 129, 8):
        for R in range(36):
            if smem(cin8, 8, 2, R) <= H100_SMEM_PER_BLOCK:
                assert smem(cin8, 16, 1, R) <= H100_SMEM_PER_BLOCK


def test_dcn_plan_narrows_the_slab_before_the_tile():
    """At C=64 R=1 the 16 x 16 plan with two buffers holds 48-channel
    slabs in 227 KB (two passes a tap); with room for a full slab it
    takes all 64 channels in one pass."""
    p = dcn_plan(64, 64, 1)
    assert (p["tile"], p["nbuf"], p["chans"], p["passes"]) == ("16x16", 2,
                                                               48, 2)
    q = dcn_plan(64, 64, 1, limit=H100_SMEM_PER_BLOCK + 8192)
    assert (q["tile"], q["nbuf"], q["chans"], q["passes"]) == ("16x16", 2,
                                                               64, 1)


def test_dcn_plan_pads_an_unaligned_input_to_16_byte_pieces():
    """The 67-channel input runs padded to 72 channels: nine 16-byte
    pieces a tile pixel, an odd count, so no extra piece; 64 channels take
    eight and one more."""
    assert _dcn_xu(72) == 9 and _dcn_xu(64) == 9 and _dcn_xu(128) == 17
    assert _dcn_xu(8) == 1 and _dcn_xu(16) == 3


@pytest.mark.parametrize("cin,cout,R", [(64, 129, 1), (64, 0, 1),
                                        (64, 64, -1), (16, 16, 37),
                                        (128, 128, 36)])
def test_dcn_plan_refuses_what_no_plan_holds(cin, cout, R):
    with pytest.raises(ValueError):
        dcn_plan(cin, cout, R)


def test_dcn_plan_is_cached_and_builds_nothing():
    assert dcn_plan(64, 64, 1) is dcn_plan(64, 64, 1)
    assert dcn_plan(64, 64, 1, 100000) is not dcn_plan(64, 64, 1)
    assert build._lib is None


class _Tensor:
    """What `_cuda_checks` reads of a tensor."""

    def __init__(self, cuda=True, dtype=torch.bfloat16, contiguous=True,
                 index=0):
        self.is_cuda, self.dtype = cuda, dtype
        self.device = torch.device("cuda", index) if cuda else torch.device(
            "cpu")
        self._contiguous, self._index = contiguous, index

    def is_contiguous(self):
        return self._contiguous

    def get_device(self):
        return self._index if self.is_cuda else -1


@pytest.mark.parametrize("bad,error,match", [
    (dict(cuda=False), ValueError, "flow on cpu, expected cuda"),
    (dict(dtype=torch.float16), TypeError, "takes bfloat16 or float32 flow"),
    (dict(contiguous=False), ValueError, "takes a contiguous flow"),
    (dict(index=1), ValueError, "tensors on different devices")])
def test_launch_checks_refuse_with_the_same_errors(bad, error, match):
    ok = _Tensor()
    assert _cuda_checks("bounded_warp", image=ok, flow=_Tensor()) == 0
    assert _cuda_checks("deform_conv2d_bounded", x=ok, offset=ok,
                        mask=None) == 0
    with pytest.raises(error, match=match):
        _cuda_checks("bounded_warp", image=ok, flow=_Tensor(**bad))


def test_wrappers_refuse_a_device_that_is_neither_cpu_nor_cuda():
    img = torch.zeros(1, 4, 8, 3, dtype=torch.bfloat16, device="meta")
    flow = torch.zeros(1, 4, 8, 2, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="image on meta, expected cuda"):
        bounded_warp(img, flow)
    x = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16, device="meta")
    off = torch.zeros(1, 4, 8, 18, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="x on meta, expected cuda"):
        deform_conv2d_bounded(x, off, None, torch.zeros(16, 16, 3, 3), None,
                              1)
