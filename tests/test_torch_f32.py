"""The kernels' float32 instances on the CPU: their plans, packing and
launch checks (pure Python, no card), the models' packing in their working
dtype, and the float32 engine on the chain-kernel route held to JAX.

- `conv2d_plan(..., itemsize=4)`, `dcn_plan(..., itemsize=4)` (the
  3xTF32 designs) and `chain_fused_plan(..., itemsize=4)` hold every
  float32 shape chip_smoke.py and tests/test_torch_cuda.py launch within
  an H100's 232,448 bytes a block, and their regions match the sums the
  float32 C entries (`vfi_conv2d_f32`, `vfi_dcn_bounded_f32`,
  `vfi_conv_chain_f32`) recompute before a launch (`_conv_entry_accepts`,
  `_dcn_entry_accepts`, `_check_fused_f32`); they refuse what nothing
  holds. Every shape the FFMA designs' plans held before them
  (`_f32_ffma_conv_plan_before`, `_f32_ffma_dcn_plan_before`: those
  searches as they were) still has a plan. The bf16 DCN plans are those
  the search made before the float32 instances (`_bf16_dcn_plan_before`,
  the search as it was), at every shape the card runs (`CARD_SHAPES`).
- `pack_conv2d` / `pack_conv_chain` / `pack_dcn` in float32 hold the
  weights unrounded, K contiguous ([Cout16][k * k * Cin8]);
  `_cuda_checks` takes bf16 or float32 operands of one dtype and refuses
  float16 and mixes; an `EMAVFI` packs in its working dtype (float32
  without one).
- `FrameInterpolator(bf16=False, conv_kernel="pallas")` (the chains
  through the kernel wrappers, which run their plain versions here) is
  held to the JAX engine in float32 with its Pallas chains, v5 DCN and
  bounded warp, to 1e-4 on [0, 1] outputs. (tests/test_torch_engine.py
  holds the "xla" route; tests/test_torch_train.py the qocc-flag train
  step with `use_pallas` against `jax.grad` in float32.)
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dcn_plan import CARD_SHAPES
from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.parallel import make_mesh
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.models import EMAVFI
from vfi_tpu_torch.ops.cuda import (chain_plan, conv2d_plan, dcn_plan,
                                    pack_conv2d, pack_conv_chain, pack_dcn)
from vfi_tpu_torch.ops.cuda.conv import (CHAIN_F32_MP, CHAIN_WARPS,
                                         F32_FLUSH_K, H100_SMEM_PER_BLOCK,
                                         ROW_PAD, TILE_H, chain_fused_plan,
                                         chain_layer_packs, packed_shape)
from vfi_tpu_torch.ops.cuda.sampling import (DCN_STREAM_ROWS, DCN_TILE_PLANS,
                                             DCN_TILE_W, _cuda_checks,
                                             _dcn_chunks, _dcn_xu)
from vfi_tpu_torch.utils.convert import load_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(c, m):
    return -(-c // m) * m


def _conv_entry_accepts(p, cin, cout, k):
    """The checks `vfi_conv2d_f32` makes of a plan before a launch (Cin
    the launch's, a multiple of 8): its tile rows (4 m-fragments a warp up
    to Cout16 = 64, else 2; half that where it flushes), two input buffers
    and the weights it recomputes from the chunk and tap group."""
    cout16 = _pad(cout, 16)
    rows = (16 if cout16 <= 64 else 8) // (2 if p["flush"] else 1)
    tg = 0 if p["resident"] else p["taps_per_group"]
    wp = (k * k * cin if tg == 0 else tg * p["ck"]) + 4
    tpx = (rows + k - 1) * (16 + k - 1)
    return (cin >= 8 and cin % 8 == 0 and 1 <= cout <= 128 and k % 2 == 1
            and k <= 9 and p["ck"] >= 8 and p["ck"] % 8 == 0
            and p["ck"] <= cin and 0 <= tg <= k * k
            and p["x_bytes"] % 128 == 0
            and p["x_bytes"] >= 4 * tpx * (p["ck"] + 4)
            and p["smem_bytes"] >= 2 * p["x_bytes"]
            + (1 if tg == 0 else 2) * 4 * cout16 * wp)


# (cin, cout, k) of every float32 conv launch the card makes: the chains'
# layers (first widths padded to 8: 67 -> 72), the
# single conv's rows, and the card tests' shapes (Cin 1, 3 and 67 padded to
# 8; k = 9 at Cout = 128).
F32_CONV_SHAPES = [
    (64, 64, 3), (128, 64, 3), (64, 2, 3), (64, 27, 3), (64, 32, 3),
    (32, 3, 3), (72, 64, 3), (72, 27, 3), (64, 32, 1), (16, 128, 1),
    (64, 64, 5), (72, 5, 5), (24, 3, 7), (200, 40, 9), (8, 16, 3),
    (128, 128, 9), (16, 48, 3), (48, 16, 3), (8, 2, 3), (72, 3, 3),
    (8, 27, 5), (8, 128, 9), (72, 128, 9), (16, 16, 9), (24, 16, 9)]


@pytest.mark.parametrize("cin,cout,k", F32_CONV_SHAPES)
def test_f32_conv2d_plan_fits_every_shape_the_card_runs(cin, cout, k):
    """The 3xTF32 conv's plan: 16 x 16 tiles up to Cout16 = 64, else 8 x
    16, halved past F32_FLUSH_K columns of K (the flush); two input buffers
    of `ck` channels (a multiple of 8 dividing Cin into `chunks`); weights
    resident or streamed in tap groups; a flushed step (a chunk's taps,
    resident; a tap group, streamed) within F32_FLUSH_K columns; within an
    H100 block's shared memory and accepted by the C entry."""
    p = conv2d_plan(cin, cout, k, itemsize=4)
    cout16, taps = _pad(cout, 16), k * k
    assert p["core"] == "tf32x3" and p["flush"] == (taps * cin > F32_FLUSH_K)
    rows = (16 if cout16 <= 64 else 8) // (2 if p["flush"] else 1)
    assert p["tile"] == f"{rows}x16"
    assert p["ck"] % 8 == 0 and p["chunks"] == -(-cin // p["ck"])
    assert p["groups"] == -(-taps // p["taps_per_group"])
    assert p["x_bytes"] == _pad(4 * (rows + k - 1) * (16 + k - 1)
                                * (p["ck"] + 4), 128)
    if p["resident"]:
        assert p["taps_per_group"] == taps
        assert p["w_pitch"] == taps * cin + 4
        w_bytes = 4 * cout16 * p["w_pitch"]
    else:
        assert p["w_pitch"] == p["taps_per_group"] * p["ck"] + 4
        w_bytes = 2 * 4 * cout16 * p["w_pitch"]
    assert p["smem_bytes"] == 2 * p["x_bytes"] + w_bytes
    assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
    assert _conv_entry_accepts(p, cin, cout, k)
    if p["flush"]:
        assert p["taps_per_group"] * p["ck"] <= F32_FLUSH_K


def test_f32_conv2d_plan_takes_the_widest_chunk_that_fits():
    """64 -> 64 at 3x3: the resident weights (148,480 bytes) leave room for
    two 16-channel buffers (25,984 each), not 32-channel ones; 64 -> 27
    fits 32-channel ones. 128 -> 64 streams its weights: of the (chunk, tap
    group) pairs that fit, 32 channels in 2 groups of 5 taps take the
    fewest steps (8). The contract's corner (k = 9, Cout = 128) flushes on
    4 x 16 tiles. A limit of 40,000 bytes holds 8-channel chunks a tap at a
    time; 30,000 bytes nothing."""
    p = conv2d_plan(64, 64, 3, itemsize=4)
    assert (p["ck"], p["resident"], p["smem_bytes"]) == (16, True, 200448)
    assert conv2d_plan(64, 27, 3, itemsize=4)["ck"] == 32
    p = conv2d_plan(128, 64, 3, itemsize=4)
    assert (p["ck"], p["resident"], p["taps_per_group"], p["groups"]) == (
        32, False, 5, 2)
    p = conv2d_plan(128, 128, 9, itemsize=4)
    assert (p["flush"], p["tile"], p["ck"]) == (True, "4x16", 16)
    p = conv2d_plan(64, 64, 3, 40000, 4)
    assert (p["ck"], p["taps_per_group"]) == (8, 1)
    with pytest.raises(ValueError):
        conv2d_plan(64, 64, 3, 30000, 4)
    assert conv2d_plan(8, 16, 3, itemsize=4)["chunks"] == 1


def _f32_ffma_conv_plan_before(cin, cout, k, limit=H100_SMEM_PER_BLOCK):
    """The FFMA float32 conv's plan as its search made it: chunks of 16, 8,
    4, 2 or 1 channels (no wider than Cin), two stages of an input tile
    [ck][16 + k - 1][20 or 28] and the chunk's weights [k k][ck][Cout16],
    two blocks an SM first."""
    pitch = 20 if k <= 5 else 28
    for cap in (limit // 2, limit):
        for ck in (16, 8, 4, 2, 1):
            if ck <= cin or ck == 1:
                smem = 2 * 4 * ck * ((16 + k - 1) * pitch + k * k
                                     * _pad(cout, 16))
                if smem <= cap:
                    return {"ck": ck, "smem_bytes": smem}
    return None


def test_f32_conv2d_plan_holds_every_shape_the_ffma_plan_held():
    """Every (Cin, Cout, odd k) the FFMA plan held (each Cin the wrapper
    passes: multiples of 8 up to 256) has a 3xTF32 plan the C entry
    accepts: the contract does not narrow."""
    for cin in range(8, 257, 8):
        for cout in (1, 2, 3, 8, 16, 27, 40, 64, 65, 96, 127, 128):
            for k in (1, 3, 5, 7, 9):
                if _f32_ffma_conv_plan_before(cin, cout, k) is None:
                    continue
                p = conv2d_plan(cin, cout, k, itemsize=4)
                assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
                assert _conv_entry_accepts(p, cin, cout, k), (cin, cout, k)


@pytest.mark.parametrize("cin,cout,k,limit,itemsize", [
    (16, 129, 3, H100_SMEM_PER_BLOCK, 4), (16, 16, 11, H100_SMEM_PER_BLOCK, 4),
    (16, 16, 2, H100_SMEM_PER_BLOCK, 4), (128, 128, 9, 30000, 4),
    (64, 64, 3, H100_SMEM_PER_BLOCK, 8)])
def test_f32_conv2d_plan_refuses_what_nothing_holds(cin, cout, k, limit,
                                                    itemsize):
    with pytest.raises(ValueError):
        conv2d_plan(cin, cout, k, limit, itemsize)


def _check_fused_f32(chans, f):
    """The float32 fused plan as the C entry (`vfi_conv_chain_f32`)
    recomputes and checks it before a launch: a plan it would refuse
    fails here; and every region fits an H100's shared memory."""
    L = len(chans) - 1
    cins = [_pad(c, 16) for c in chans[:-1]]
    couts = [_pad(c, 16) for c in chans[1:]]
    th, tw, ck = f["th"], f["tw"], f["ck"]
    P = tw + 2 * L
    assert f["pitch_px"] == P and f["tile"] == f"{th}x{tw}"
    assert ck >= 4 and ck % 4 == 0 and f["pitch"] == [c + 4 for c in cins]
    assert f["chunks"] == [-(-c // ck) for c in cins]
    need = [0, 0]
    for l in range(L):
        n = (th + 2 * (L - 1 - l)) * (tw + 2 * (L - 1 - l))
        per_lane = -(-n // (32 * (CHAIN_WARPS // (couts[l] // 8))))
        assert f["positions_per_lane"][l] == per_lane <= CHAIN_F32_MP
        need[l % 2] = max(need[l % 2],
                          4 * (th + 2 * (L - l)) * P * (cins[l] + 4))
    b0, b1 = f["buf_bytes"]
    assert b0 % 128 == 0 and b1 % 128 == 0 and f["slot_bytes"] % 128 == 0
    assert b0 >= need[0] and b1 >= need[1]
    assert f["slot_bytes"] >= max(4 * 9 * min(ck, ci) * co
                                  for ci, co in zip(cins, couts))
    assert f["smem_bytes"] >= b0 + b1 + 2 * f["slot_bytes"]
    assert f["smem_bytes"] <= H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("chans,acts", [
    ((64, 64, 64, 64), (True,) * 3), ((128, 64, 64, 2), (True, True, False)),
    ((64, 27), (False,)), ((67, 64, 32, 3), (True, True, False))])
def test_f32_chain_plan_runs_the_layers(chans, acts):
    """A float32 chain runs its layers, each on the float32 conv plan of
    its widths padded to 8; beside it, a chain of 2-4 layers has the fused
    kernel's float32 plan (`conv_chain_fused` runs it), one layer
    none."""
    p = chain_plan(chans, acts, 1, 720, 1280, itemsize=4)
    if len(chans) == 2:
        assert chain_fused_plan(chans, itemsize=4) is None
    else:
        _check_fused_f32(chans, chain_fused_plan(chans, itemsize=4))
    widths = [_pad(c, 8) for c in chans[:-1]] + [chans[-1]]
    assert p == [conv2d_plan(ci, co, 3, itemsize=4)
                 for ci, co in zip(widths[:-1], widths[1:])]


# Every float32 chain shape the card runs (chip_smoke.py's float32 chain
# rows and tests/test_torch_cuda.py's) and their tiles: the 128-wide input
# of the motion chain, and four layers, leave room for 8 x 8 tiles only.
@pytest.mark.parametrize("chans,tile,ck", [
    ((64, 64, 64, 64), "8x16", 16), ((128, 64, 64, 2), "8x8", 16),
    ((64, 64, 32, 3), "8x16", 16), ((67, 64, 32, 3), "8x16", 8),
    ((64, 64, 64, 64, 64), "8x8", 16), ((16, 27, 64, 16, 48), "8x16", 16)])
def test_f32_chain_fused_plan_fits_every_card_shape(chans, tile, ck):
    f = chain_fused_plan(chans, itemsize=4)
    _check_fused_f32(chans, f)
    assert (f["tile"], f["ck"]) == (tile, ck)


@pytest.mark.parametrize("L", [2, 3, 4])
@pytest.mark.parametrize("c0", [8, 24, 64, 72, 128])
@pytest.mark.parametrize("cout", [1, 27, 48, 64])
def test_f32_chain_fused_plan_fits_the_contract_extremes(L, c0, cout):
    """2..4 layers, Cout <= 64 (48: six channel groups on eight warps),
    first widths 8..128: the float32 fused kernel has a plan within an
    H100's shared memory."""
    for chans in ((c0,) + (64,) * (L - 1) + (cout,), (c0,) + (cout,) * L):
        _check_fused_f32(chans, chain_fused_plan(chans, itemsize=4))


def test_f32_chain_fused_plan_refuses_what_shared_memory_cannot_hold():
    assert chain_fused_plan((512, 64, 64), itemsize=4) is None
    assert chain_fused_plan((64, 64, 64), 40000, 4) is None
    with pytest.raises(ValueError, match="itemsize"):
        chain_fused_plan((64, 64, 64), itemsize=8)


def _dcn_entry_accepts(p, cin, cout, R):
    """The regions `vfi_dcn_bounded_f32` recomputes from a plan and the
    checks it makes before a launch (Cin the launch's, padded to 8): a
    plan the entry would refuse fails here."""
    cin8, cout16 = _pad(cin, 8), _pad(cout, 16)
    rows, chans, xu = p["rows"], p["chans"], p["xu"]
    tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
    s_bytes = 4 * rows * DCN_TILE_W * (chans + 4)
    ok = (p["core"] == "tf32x3" and 8 <= chans <= cin8 and chans % 8 == 0
          and p["nbuf"] == 1 and p["x_bytes"] % 128 == 0
          and p["x_bytes"] >= 16 * tpx * xu)
    if p["design"] == "tile":
        pieces = cin8 // 4
        return (ok and rows == 8 and cin8 <= F32_FLUSH_K
                and xu == pieces + (pieces % 2 == 0)
                and p["smem_bytes"] >= 4 * cout16 * (9 * cin8 + 4)
                + p["x_bytes"] + s_bytes)
    return (ok and rows in (8, 4) and xu >= chans // 4
            and chans <= F32_FLUSH_K
            and p["smem_bytes"] >= 2 * 4 * cout16 * (chans + 4)
            + p["x_bytes"] + s_bytes)


# (cin, cout, R, design, tile) of the float32 DCN launches: chip_smoke.py's
# rows (C=64 R=1 at every path shape; C=67 R=2 and R=8) and the card
# tests' (tile on 8 x 16, stream in one chunk and several, 8-channel
# chunks of 4 x 16 tiles at R = 28 and 35; Cin 1 and 3, Cout 2, 3 and 27;
# Cout16 80, 96 and 112 on both designs; Cin past 128 on both, and 1200 in
# stream chunks of at most F32_FLUSH_K).
F32_DCN_SHAPES = [
    (64, 64, 1, "tile", "8x16"), (67, 67, 2, "stream", "8x16"),
    (67, 67, 8, "stream", "8x16"), (16, 32, 2, "tile", "8x16"),
    (3, 24, 2, "tile", "8x16"), (64, 27, 0, "tile", "8x16"),
    (67, 5, 2, "tile", "8x16"), (128, 128, 4, "stream", "8x16"),
    (80, 67, 4, "stream", "8x16"), (128, 8, 28, "stream", "4x16"),
    (128, 128, 35, "stream", "4x16"), (64, 13, 2, "tile", "8x16"),
    (13, 37, 3, "tile", "8x16"), (1, 16, 1, "tile", "8x16"),
    (3, 2, 1, "tile", "8x16"), (67, 3, 2, "tile", "8x16"),
    (64, 27, 1, "tile", "8x16"), (67, 27, 8, "stream", "8x16"),
    (128, 3, 35, "stream", "4x16"), (128, 2, 34, "stream", "8x16"),
    (16, 80, 1, "tile", "8x16"), (16, 96, 1, "tile", "8x16"),
    (16, 112, 1, "tile", "8x16"), (64, 80, 4, "stream", "8x16"),
    (64, 96, 4, "stream", "8x16"), (64, 112, 4, "stream", "8x16"),
    (128, 16, 0, "tile", "8x16"), (136, 16, 0, "tile", "8x16"),
    (256, 16, 1, "stream", "8x16"), (1200, 16, 1, "stream", "8x16")]


@pytest.mark.parametrize("cin,cout,R,design,tile", F32_DCN_SHAPES)
def test_f32_dcn_plan_fits_every_shape_the_card_runs(cin, cout, R, design,
                                                     tile):
    p = dcn_plan(cin, cout, R, itemsize=4)
    assert (p["design"], p["tile"], p["core"]) == (design, tile, "tf32x3")
    assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
    assert _dcn_entry_accepts(p, cin, cout, R)
    cin8, cout16 = _pad(cin, 8), _pad(cout, 16)
    if design == "tile":
        assert p["w_bytes"] == 4 * cout16 * (9 * cin8 + 4)
        assert p["passes"] == -(-cin8 // p["chans"])
    else:
        assert p["w_bytes"] == 2 * 4 * cout16 * (p["chans"] + 4)
        assert p["chunks"] == -(-cin8 // p["chans"])
    assert p["s_bytes"] == 4 * p["rows"] * 16 * (p["chans"] + 4)
    assert p["smem_bytes"] == (p["w_bytes"] + p["x_bytes"] + p["s_bytes"])


@pytest.mark.parametrize("cin,crossover", [(64, 2), (67, 0), (128, 0)])
def test_f32_dcn_plan_crossover_to_the_stream_design(cin, crossover):
    """Float32 weights take twice the bytes: C -> C keeps them resident
    (the tile design) only for C = 64 up to R = 1; C = 67 and C = 128 run
    the stream design at every R."""
    designs = [dcn_plan(cin, cin, R, itemsize=4)["design"]
               for R in range(36)]
    assert designs == ["tile"] * crossover + ["stream"] * (36 - crossover)


def test_f32_dcn_plan_holds_every_shape_up_to_r35():
    """Every Cin <= 128 (in 8-channel pieces), Cout <= 128 and R <= 35 has
    a 3xTF32 plan within an H100's shared memory that the C entry accepts,
    as in bf16: at R = 35 the stream design's 4 x 16 tile in 8-channel
    chunks takes 229,376 bytes at Cout 128."""
    for cin in range(8, 129, 8):
        for cout in range(16, 129, 16):
            for R in range(36):
                p = dcn_plan(cin, cout, R, itemsize=4)
                assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
                assert _dcn_entry_accepts(p, cin, cout, R), (cin, cout, R)
    assert dcn_plan(128, 128, 35, itemsize=4)["smem_bytes"] == 229376


def _f32_ffma_dcn_plan_before(cin, cout, R, limit=H100_SMEM_PER_BLOCK):
    """Whether the FFMA float32 DCN's search found a plan: the tile design
    (weights [9 Cin16][Cout16] resident, one input buffer, 16 x 16 then 8 x
    16 tiles, slabs [chans][20] floats), else the stream design on 8 x 16
    tiles (chunks of Cin16 split into multiples of 16, then 8 and 4
    channels; padded pixel stride, then unpadded)."""
    cin8, cin16, cout16 = _pad(cin, 8), _pad(cin, 16), _pad(cout, 16)
    pieces = cin8 // 4
    xu = pieces + (pieces % 2 == 0)
    for rows in (16, 8):
        tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
        if (4 * 9 * cin16 * cout16 + _pad(tpx * xu * 16, 128)
                + 4 * rows * 16 * 20 <= limit):
            return True
    for padded in (True, False):
        tpx = (8 + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
        for chans in _dcn_chunks(cin16) + [8, 4]:
            p4 = min(chans, cin8) // 4
            sxu = p4 + (p4 % 2 == 0) if padded else p4
            if (2 * 4 * chans * cout16 + _pad(tpx * sxu * 16, 128)
                    + 4 * 8 * chans * 20 <= limit):
                return True
    return False


@pytest.mark.parametrize("cin", [8, 24, 64, 67, 72, 128, 200, 256])
def test_f32_dcn_plan_holds_every_shape_the_ffma_plan_held(cin):
    """Case for case against the FFMA search: wherever it had a plan
    (R <= 35, Cout 1..128), the 3xTF32 plan exists and the C entry accepts
    it: the contract does not narrow."""
    for cout in (1, 2, 3, 16, 27, 64, 67, 96, 128):
        for R in range(36):
            if not _f32_ffma_dcn_plan_before(cin, cout, R):
                continue
            p = dcn_plan(cin, cout, R, itemsize=4)
            assert _dcn_entry_accepts(p, cin, cout, R), (cin, cout, R)


@pytest.mark.parametrize("cin,cout,R,itemsize", [
    (64, 129, 1, 4), (64, 0, 1, 4), (64, 64, -1, 4), (128, 128, 60, 4),
    (64, 64, 1, 8)])
def test_f32_dcn_plan_refuses_what_no_plan_holds(cin, cout, R, itemsize):
    with pytest.raises(ValueError):
        dcn_plan(cin, cout, R, itemsize=itemsize)


def _bf16_dcn_plan_before(cin, cout, R, limit=H100_SMEM_PER_BLOCK):
    """The bf16 plan as the search made it before the float32 instances:
    the tile design (16 x 16 with two buffers, one, 8 x 16 with one; the
    widest 16-channel multiple of slab), else the stream design (8 x 16,
    then 4 x 16; the widest chunk; padded pixel stride, then unpadded)."""
    cin8, cin16, cout16 = _pad(cin, 8), _pad(cin, 16), _pad(cout, 16)
    xu = cin8 // 8 + (cin8 // 8 % 2 == 0)
    w_bytes = 9 * cin16 * (cout16 + ROW_PAD) * 2
    for rows, nbuf in DCN_TILE_PLANS:
        tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
        x_bytes = _pad(tpx * xu * 16, 128)
        for chans in range(cin16, 0, -16):
            s_bytes = rows * DCN_TILE_W * (chans + ROW_PAD) * 2
            if s_bytes <= limit - w_bytes - nbuf * x_bytes:
                return {"design": "tile", "tile": f"{rows}x{DCN_TILE_W}",
                        "rows": rows, "nbuf": nbuf, "chans": chans,
                        "passes": -(-cin16 // chans), "xu": xu,
                        "x_bytes": x_bytes, "w_bytes": w_bytes,
                        "s_bytes": s_bytes,
                        "smem_bytes": w_bytes + nbuf * x_bytes + s_bytes}
    for padded in (True, False):
        for rows in DCN_STREAM_ROWS:
            tpx = (rows + 2 + 2 * R) * (DCN_TILE_W + 2 + 2 * R)
            for chans in _dcn_chunks(cin16):
                pieces = min(chans, cin8) // 8
                sxu = pieces + (pieces % 2 == 0) if padded else pieces
                x_bytes = _pad(tpx * sxu * 16, 128)
                w_bytes = 2 * chans * (cout16 + ROW_PAD) * 2
                s_bytes = rows * DCN_TILE_W * (chans + ROW_PAD) * 2
                if w_bytes + x_bytes + s_bytes <= limit:
                    return {"design": "stream",
                            "tile": f"{rows}x{DCN_TILE_W}", "rows": rows,
                            "nbuf": 1, "chans": chans,
                            "chunks": -(-cin16 // chans), "xu": sxu,
                            "x_bytes": x_bytes, "w_bytes": w_bytes,
                            "s_bytes": s_bytes,
                            "smem_bytes": w_bytes + x_bytes + s_bytes}
    return None


@pytest.mark.parametrize("cin,cout,R,design", CARD_SHAPES)
def test_bf16_dcn_plans_are_unchanged(cin, cout, R, design):
    want = _bf16_dcn_plan_before(cin, cout, R)
    assert dcn_plan(cin, cout, R) == want
    assert dcn_plan(cin, cout, R, itemsize=2) == want
    assert want["design"] == design


def test_bf16_and_f32_pixel_strides():
    """A 16-byte piece holds 8 bf16 or 4 float32 channels; the stride is
    odd either way (64 channels: 9 pieces in bf16, 17 in float32)."""
    assert [_dcn_xu(c) for c in (8, 64, 72)] == [1, 9, 9]
    assert [_dcn_xu(c, 4) for c in (8, 64, 72)] == [3, 17, 19]


def test_f32_packs_hold_the_weights_unrounded():
    """`pack_conv2d(..., torch.float32)`: [Cout16][kh*kw*Cin8] float32, K
    contiguous (column t * Cin8 + c, t = kw * i + j), every weight exactly,
    zero padding; the bias float32 exactly. The bf16 default ([kh*kw*Cin16]
    [Cout16]) rounds both, as before; float16 raises."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 1, (27, 13, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, 27).astype(np.float32))
    wpk, bpk = pack_conv2d(w, b, torch.float32)
    assert wpk.dtype == bpk.dtype == torch.float32
    assert tuple(wpk.shape) == (32, 9 * 16) == packed_shape(13, 27, 3,
                                                             torch.float32)
    grid = wpk.view(32, 3, 3, 16)
    assert torch.equal(grid[:27, :, :, :13], w.permute(0, 2, 3, 1))
    assert not grid[27:].any() and not grid[..., 13:].any()
    assert wpk[5, 4 * 16 + 7] == w[5, 7, 1, 1]
    assert torch.equal(bpk[:27], b) and not bpk[27:].any()
    wb, bb = pack_conv2d(w, b)
    assert wb.dtype == torch.bfloat16 and bb.dtype == torch.float32
    assert torch.equal(wb.float().view(3, 3, 16, 32)[:, :, :13, :27],
                       w.to(torch.bfloat16).float().permute(2, 3, 1, 0))
    assert torch.equal(bb[:27], b.to(torch.bfloat16).float())
    assert torch.equal(pack_dcn(w, b, torch.float32)[0], wpk)
    with pytest.raises(TypeError):
        pack_conv2d(w, b, torch.float16)


def test_f32_chain_pack_is_each_layers_pack():
    rng = np.random.default_rng(1)
    chans = (67, 64, 32, 3)
    ws = [torch.from_numpy(rng.normal(0, 1, (co, ci, 3, 3)).astype(
        np.float32)) for ci, co in zip(chans[:-1], chans[1:])]
    bs = [torch.from_numpy(rng.normal(0, 1, co).astype(np.float32))
          for co in chans[1:]]
    wpk, bpk = pack_conv_chain(ws, bs, torch.float32)
    assert wpk.dtype == torch.float32
    for (wl, bl), w, b in zip(chain_layer_packs(wpk, bpk, chans), ws, bs):
        ref = pack_conv2d(w, b, torch.float32)
        assert torch.equal(wl, ref[0]) and torch.equal(bl, ref[1])


class _Tensor:
    """What `_cuda_checks` reads of a tensor."""

    def __init__(self, dtype=torch.bfloat16, index=0):
        self.is_cuda, self.dtype, self._index = True, dtype, index
        self.device = torch.device("cuda", index)

    def is_contiguous(self):
        return True

    def get_device(self):
        return self._index


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_checks_take_bf16_and_f32(dtype):
    t = _Tensor(dtype)
    assert _cuda_checks("bounded_warp", image=t, flow=_Tensor(dtype)) == 0
    assert _cuda_checks("deform_conv2d_bounded", x=t, offset=t,
                        mask=None) == 0


@pytest.mark.parametrize("dtypes,match", [
    ((torch.float16, torch.float16), "takes bfloat16 or float32 image"),
    ((torch.float64, torch.float64), "takes bfloat16 or float32 image"),
    ((torch.float32, torch.bfloat16), "operands of one dtype"),
    ((torch.bfloat16, torch.float32), "operands of one dtype")])
def test_launch_checks_refuse_other_and_mixed_dtypes(dtypes, match):
    with pytest.raises(TypeError, match=match):
        _cuda_checks("bounded_warp", image=_Tensor(dtypes[0]),
                     flow=_Tensor(dtypes[1]))


@pytest.mark.parametrize("dtype,packed", [(None, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_a_model_packs_in_its_working_dtype(dtype, packed):
    """Every chain and DCN pack of an EMAVFI is in its working dtype
    (float32 without one), each equal to packing its live weights in it."""
    torch.manual_seed(0)
    m = EMAVFI(mid_channels=16, num_blocks=2, dtype=dtype, dcn_max_offset=1,
               warp_max_flow=16, fuse_project=True, conv_kernel="pallas")
    m.pack_kernel_weights()
    for names, (wpk, _) in m.packed.items():
        convs = [getattr(m, n).conv for n in names]
        assert wpk.dtype == packed
        assert torch.equal(wpk, pack_conv_chain(
            [c.weight for c in convs], [c.bias for c in convs], packed)[0])
    for i in range(2):
        dcn = getattr(m, f"fusion_dcn{i}")
        assert dcn.packed[0][0].dtype == dcn.packed[1][0].dtype == packed
        assert torch.equal(dcn.packed[1][0],
                           pack_dcn(dcn.weight, dcn.bias, packed)[0])


@pytest.fixture(scope="module")
def qocc():
    return load_params_npz(QOCC + ".npz"), load_params_npz(QOCC + ".flow.npz")


def test_f32_engine_on_the_chain_route_matches_jax(qocc):
    """The flagship settings in float32 with conv_kernel="pallas": the
    engine packs float32 weights (the float32 instances' layout on the
    card) and its midpoints match the JAX engine's in float32 (Pallas
    chains, v5 DCN, bounded warp) to 1e-4."""
    rng = np.random.default_rng(12)
    f0 = rng.uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    f1 = np.roll(f0, (2, -3), axis=(1, 2))
    kw = dict(dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
              conv_kernel="pallas", bf16=False)
    eng = FrameInterpolator(qocc[0], flow_params=qocc[1], device="cpu", **kw)
    packs = [w for w, _ in eng.model.packed.values()]
    packs += [t for i in range(3) for t, _ in
              getattr(eng.model, f"fusion_dcn{i}").packed]
    assert len(packs) == 9 and all(w.dtype == torch.float32 for w in packs)
    got = eng.midpoints(f0, f1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JFI(qocc[0], flow_params=qocc[1], use_pallas=True,
                             dcn_kernel="v5",
                             mesh=make_mesh(devices=jax.devices()[:1]),
                             **kw).midpoints(f0, f1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cli", ["eval", "infer", "serve"])
def test_fp32_help_names_the_float32_kernels(cli, capsys):
    """The CLIs' `--fp32` runs the kernels' float32 instances on the card;
    no help says it needs the CPU."""
    import importlib

    mod = importlib.import_module(f"vfi_tpu_torch.cli.{cli}")
    parser = mod.build_parser()
    argv = ["two-frame", "--help"] if cli == "infer" else ["--help"]
    with pytest.raises(SystemExit):
        parser.parse_args(argv)
    text = capsys.readouterr().out
    assert "--fp32" in text and "float32 instances" in " ".join(text.split())
    assert "CPU only" not in text
