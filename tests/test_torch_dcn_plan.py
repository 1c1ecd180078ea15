"""The DCN kernel's plan (`vfi_tpu_torch.ops.cuda.dcn_plan`, pure Python,
no card) and the sampling wrappers' launch checks on the CPU.

`dcn_plan` picks the design of `csrc/dcn_bounded.cu` a launch runs ("tile":
the weight-stationary GEMM on 16 x 16 output tiles with two input buffers
or one, or 8 x 16 tiles with one; "strip" where no tile plan fits) and its
shared memory. Every
DCN shape the card runs (chip_smoke.py's kernel rows and
tests/test_torch_cuda.py) must fit an H100's 232,448 bytes a block; the
search falls back in a stated order and refuses what nothing holds.

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
from vfi_tpu_torch.ops.cuda.sampling import DCN_TILE_W, _cuda_checks, _dcn_xu


def _pad(c, m):
    return -(-c // m) * m


# (cin, cout, R, design) of every DCN launch the card makes: chip_smoke.py's
# rows (qocc C=64 R=1; q12 C=67 R=2; C=67 R=4 and 8, C=128 R=4 and 8) and
# the card tests' shapes.
CARD_SHAPES = [
    (64, 64, 1, "tile"), (67, 67, 2, "tile"), (67, 67, 4, "tile"),
    (67, 67, 8, "strip"), (128, 128, 4, "strip"), (128, 128, 8, "strip"),
    (16, 32, 2, "tile"), (32, 16, 3, "tile"), (64, 128, 1, "tile"),
    (67, 5, 2, "tile"), (3, 24, 2, "tile"), (80, 67, 4, "tile"),
    (64, 64, 3, "tile"), (64, 64, 5, "tile"), (64, 64, 8, "tile"),
    (128, 128, 6, "strip"), (67, 67, 20, "strip"), (64, 27, 0, "tile"),
    (64, 67, 4, "tile"), (64, 64, 2, "tile"), (67, 67, 1, "tile"),
    (67, 67, 3, "tile")]


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
        assert p["px"] in (64, 32, 16) and p["ck"] % 16 == 0
        assert p["chunks"] == -(-cin16 // p["ck"])
        assert p["ck"] == cin16 or p["px"] == 16


@pytest.mark.parametrize("cin,cout,R,want", [
    (64, 64, 1, ("tile", "16x16", 2)), (64, 64, 3, ("tile", "16x16", 1)),
    (67, 67, 2, ("tile", "16x16", 1)), (64, 64, 5, ("tile", "16x16", 1)),
    (64, 64, 8, ("tile", "8x16", 1)), (67, 67, 4, ("tile", "8x16", 1)),
    (128, 128, 1, ("strip", 64, 1)), (128, 128, 4, ("strip", 32, 1)),
    (128, 128, 8, ("strip", 16, 2)), (67, 67, 20, ("strip", 16, 3))])
def test_dcn_plan_falls_back_in_order(cin, cout, R, want):
    """16 x 16 tiles with two buffers, then with one, then 8 x 16 tiles
    with one; where no tile plan holds the resident weights and a buffer,
    the strip design: 64, 32, 16 pixels, then 16 pixels with channel
    chunks."""
    p = dcn_plan(cin, cout, R)
    if want[0] == "tile":
        assert (p["design"], p["tile"], p["nbuf"]) == want
    else:
        assert (p["design"], p["px"], p["chunks"]) == want


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
    (dict(dtype=torch.float32), TypeError, "takes bfloat16 flow"),
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
