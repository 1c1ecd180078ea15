"""The conv chain's plans (`vfi_tpu_torch.ops.cuda.chain_plan` and
`chain_fused_plan`, pure Python, no card), `conv_chain_fused` on the CPU,
and the auto_scale probe's percentile
(`vfi_tpu_torch.infer.pair.percentile_linear`) on the CPU.

`chain_plan` is the chain's contract and its layers' plans (one launch of
`csrc/conv2d.cu` a layer, `conv_chain`); `chain_fused_plan` is the tile
plan of the fused kernel (`csrc/conv_chain.cu`, `conv_chain_fused`).
Every chain shape a path launches (chip_smoke.py's rows) and the
contract's extremes (2..4 layers, Cout <= 64, first widths 8..128 and 72)
must fit an H100's 232,448 bytes a block in both; past the contract
`chain_plan` raises a ValueError naming the limit. On the CPU
`conv_chain_fused` is the plain version, bit for bit, and refuses what
`conv_chain` refuses before any dispatch.

The percentile replaces `torch.quantile`, which refuses more than 2^24
elements, in `FrameInterpolator._flow_p95`. It is held against
`jnp.percentile` (the reference's `p95_flow`) at small sizes with ties to
1e-6 relative, and against `numpy.percentile` on 2^24 + 1,000 values.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.infer.pair import percentile_linear
from vfi_tpu_torch.ops.cuda import (chain_plan, conv2d_plan, conv_chain,
                                    conv_chain_fused, conv_chain_plain,
                                    pack_conv2d, pack_conv_chain,
                                    reset_launch_counts)
from vfi_tpu_torch.ops.cuda.conv import (CHAIN_MF, CHAIN_WARPS,
                                         H100_SMEM_PER_BLOCK, ROW_PAD,
                                         chain_fused_plan, chain_layer_packs)
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


RELU3 = (True, True, True)
RRN = (True, True, False)
# (chans, acts, b, h, w) of every chain launch the paths make: the main
# path at 720p and its cascade's 360x640, q12's b=4 batch at 480x640 and
# 240x320, the one-layer offset convs.
PATH_SHAPES = [
    ((64, 64, 64, 64), RELU3, 1, 720, 1280),
    ((128, 64, 64, 2), RRN, 1, 720, 1280),
    ((64, 64, 32, 3), RRN, 1, 720, 1280),
    ((64, 64, 64, 64), RELU3, 1, 360, 640),
    ((128, 64, 64, 2), RRN, 1, 360, 640),
    ((64, 64, 64, 64), RELU3, 4, 480, 640),
    ((128, 64, 64, 2), RRN, 4, 480, 640),
    ((64, 64, 64, 64), RELU3, 4, 240, 320),
    ((128, 64, 64, 2), RRN, 4, 240, 320),
    ((67, 64, 32, 3), RRN, 4, 480, 640),
    ((64, 27), (False,), 1, 720, 1280),
    ((67, 27), (False,), 4, 480, 640),
]


def _check_fused(chans, f):
    """The fused plan as the C entry (`vfi_conv_chain_bf16`) checks it."""
    L = len(chans) - 1
    cins = [_pad(c, 16) for c in chans[:-1]]
    couts = [_pad(c, 16) for c in chans[1:]]
    P = f["tw"] + 2 * L
    assert f["pitch_px"] == P and f["tile"] == f"{f['th']}x{f['tw']}"
    assert f["frags"] == [-(-(f["th"] + 2 * (L - 1 - l)) * P // 16)
                          for l in range(L)]
    assert max(f["frags"]) <= CHAIN_WARPS * CHAIN_MF
    assert f["buf_px"] == f["frags"][0] * 16 + 2 * P + 2
    assert f["buf_bytes"] % 128 == 0 and f["slot_bytes"] % 128 == 0
    assert f["buf_bytes"] >= f["buf_px"] * (max(cins) + ROW_PAD) * 2
    for tg, ci, co in zip(f["taps_per_group"], cins, couts):
        assert 1 <= tg <= 9
        assert f["slot_bytes"] >= tg * ci * (co + ROW_PAD) * 2
    assert f["groups"] == [-(-9 // t) for t in f["taps_per_group"]]
    assert f["smem_bytes"] == 2 * f["buf_bytes"] + 2 * f["slot_bytes"]
    assert f["smem_bytes"] <= H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("chans,acts,b,h,w", PATH_SHAPES)
def test_chain_plan_fits_every_path_shape(chans, acts, b, h, w):
    p = chain_plan(chans, acts, b, h, w)
    L = len(chans) - 1
    widths = [_pad(c, 8) for c in chans[:-1]] + [chans[-1]]
    assert p == [conv2d_plan(ci, co, 3)
                 for ci, co in zip(widths[:-1], widths[1:])]
    assert all(q["smem_bytes"] <= H100_SMEM_PER_BLOCK for q in p)
    if L == 1:   # one layer is one conv: the conv kernel
        assert chain_fused_plan(chans) is None
    else:        # the fused kernel runs every chain a path launches
        _check_fused(chans, chain_fused_plan(chans))


@pytest.mark.parametrize("L", [2, 3, 4])
@pytest.mark.parametrize("c0", [8, 16, 24, 32, 48, 64, 72, 96, 120, 128])
@pytest.mark.parametrize("cout", [1, 3, 27, 64])
def test_chain_plan_fits_the_contract_extremes(L, c0, cout):
    """2..4 layers, Cout <= 64, first widths 8..128 and 72: the layers
    and the fused kernel both have a plan within an H100's shared
    memory."""
    chans = (c0,) + (64,) * (L - 1) + (cout,)
    p = chain_plan(chans, (True,) * L, 1, 37, 53)
    _check_fused(chans, chain_fused_plan(chans))
    assert all(q["smem_bytes"] <= H100_SMEM_PER_BLOCK for q in p)
    narrow = (c0,) + (cout,) * L
    _check_fused(narrow, chain_fused_plan(narrow))


@pytest.mark.parametrize("chans,acts,match", [
    ((64,), (), "1..4 layers"),
    ((64, 64, 64, 64, 64, 64), (True,) * 5, "1..4 layers"),
    ((64, 65, 3), (True, False), "cout <= 64"),
    ((64, 64, 0), (True, False), "cout <= 64"),
    ((0, 64), (True,), "cout <= 64"),
    ((64, 64, 3), (True,), "2 layers"),
])
def test_chain_plan_refuses_past_its_limits(chans, acts, match):
    with pytest.raises(ValueError, match=match):
        chain_plan(chans, acts, 1, 8, 16)


def test_chain_fused_plan_refuses_what_shared_memory_cannot_hold():
    """An input too wide for two activation buffers has no fused plan
    (`conv_chain_fused` raises there); its layers have plans, which
    `conv_chain` runs."""
    assert chain_fused_plan((512, 64, 64)) is None
    p = chain_plan((512, 64, 64), (True, True), 1, 8, 16)
    assert len(p) == 2
    assert all(q["smem_bytes"] <= H100_SMEM_PER_BLOCK for q in p)
    assert chain_fused_plan((64, 64, 64)) is not None
    assert chain_fused_plan((64, 64, 64), 4096) is None


def test_chain_plan_is_deterministic_and_cached():
    chain_plan.cache_clear()
    a = chain_plan((64, 64, 64, 64), RELU3, 1, 720, 1280)
    b = chain_plan((64, 64, 64, 64), RELU3, 1, 720, 1280)
    assert a is b
    chain_plan.cache_clear()
    assert chain_plan((64, 64, 64, 64), RELU3, 1, 720, 1280) == a


def test_chain_plan_tiles_fall_back_in_order():
    """16 x 16 output tiles where the buffers fit, then 8 x 16, then
    8 x 8; q12's and the flagship's 64-wide chains take 16 x 16, the
    128-wide motion chain 8 x 16."""
    assert chain_fused_plan((64, 64, 64, 64))["tile"] == "16x16"
    assert chain_fused_plan((64, 64, 32, 3))["tile"] == "16x16"
    assert chain_fused_plan((67, 64, 32, 3))["tile"] == "16x16"
    assert chain_fused_plan((128, 64, 64, 2))["tile"] == "8x16"
    assert chain_fused_plan((128, 64, 64, 64, 64))["tile"] == "8x8"


@pytest.mark.parametrize("chans", [(64, 64, 64, 64), (128, 64, 64, 2),
                                   (67, 64, 32, 3), (16, 48, 16, 8, 5),
                                   (24, 27, 19), (64, 27)])
def test_layers_route_packing_slices_are_each_layers_pack_conv2d(chans):
    rng = np.random.default_rng(3)
    ws = [torch.from_numpy(rng.standard_normal((co, ci, 3, 3)).astype(
        np.float32)) for ci, co in zip(chans[:-1], chans[1:])]
    bs = [torch.from_numpy(rng.standard_normal(co).astype(np.float32))
          for co in chans[1:]]
    wpk, bpk = pack_conv_chain(ws, bs)
    packs = chain_layer_packs(wpk, bpk, chans)
    assert len(packs) == len(ws)
    for (wl, bl), w, b in zip(packs, ws, bs):
        we, be = pack_conv2d(w, b)
        assert wl.shape == we.shape and torch.equal(wl, we)
        assert bl.shape == be.shape and torch.equal(bl, be)


def _chain_case(chans, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16, chans[0])).astype(
        np.float32)).to(torch.bfloat16)
    ws = [torch.from_numpy((rng.standard_normal((co, ci, 3, 3))
                            / (9 * ci) ** 0.5).astype(np.float32))
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [torch.from_numpy(rng.standard_normal(co).astype(np.float32) * 0.1)
          for co in chans[1:]]
    return x, ws, bs


@pytest.mark.parametrize("split", [False, True], ids=["tensor", "parts"])
@pytest.mark.parametrize("chans,acts", [PATH_SHAPES[0][:2],
                                        PATH_SHAPES[1][:2],
                                        PATH_SHAPES[9][:2]])
def test_conv_chain_fused_cpu_is_the_plain_version(chans, acts, split):
    """On the CPU the fused kernel's wrapper runs the plain version, bit
    for bit, on one tensor or on two parts split along channels (the
    motion chain's and the reference topology's 64 + the rest), and
    launches nothing."""
    x, ws, bs = _chain_case(chans)
    arg = (x[..., :64], x[..., 64:]) if split and chans[0] > 64 else (
        (x[..., :32], x[..., 32:]) if split else x)
    reset_launch_counts()
    assert torch.equal(conv_chain_fused(arg, ws, bs, acts),
                       conv_chain_plain(x, ws, bs, acts))
    assert conv_chain_fused.launches == 0
    assert not conv_chain_fused.launches_by_shape


@pytest.mark.parametrize("change,match", [
    (lambda ws, bs, acts: ([ws[0][..., :1, :1]] + ws[1:], bs, acts),
     "not OIHW 3x3"),
    (lambda ws, bs, acts: ([ws[0][:, :-1]] + ws[1:], bs, acts),
     "not OIHW 3x3"),
    (lambda ws, bs, acts: (ws, bs[:-1], acts), "differ in length"),
    (lambda ws, bs, acts: (ws, bs, acts[:-1]), "differ in length"),
], ids=["1x1", "cin", "biases", "acts"])
def test_conv_chain_fused_refuses_what_conv_chain_refuses(change, match):
    """The argument checks both chain wrappers share, made before any
    dispatch: a weight that is not OIHW 3x3 on the input's width, and
    weights, biases and acts of different lengths."""
    chans, acts = PATH_SHAPES[2][:2]
    x, ws, bs = _chain_case(chans)
    for fn in (conv_chain, conv_chain_fused):
        with pytest.raises(ValueError, match=match):
            fn(x, *change(ws, bs, acts))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 20, 101, 1000])
def test_percentile_matches_jnp_percentile(n):
    """Seeded magnitudes with ties (a third of the values repeat a few
    levels), `jnp.percentile`'s linear interpolation, 1e-6 relative."""
    rng = np.random.default_rng(n)
    a = rng.gamma(2.0, 2.0, n).astype(np.float32)
    a[: n // 3] = rng.choice(a, n // 3)
    for q in (0.0, 50.0, 95.0, 99.9, 100.0):
        want = float(jnp.percentile(jnp.asarray(a), q))
        got = percentile_linear(torch.from_numpy(a), q)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_percentile_takes_more_than_2_pow_24_elements():
    """`torch.quantile` refuses this input; the percentile matches
    `numpy.percentile` (float64 arithmetic) to 1e-6 relative."""
    rng = np.random.default_rng(0)
    a = rng.gamma(2.0, 2.0, 2 ** 24 + 1000).astype(np.float32)
    t = torch.from_numpy(a)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(t, 0.95)
    got = percentile_linear(t, 95.0)
    assert got == pytest.approx(float(np.percentile(a, 95.0)), rel=1e-6)


def test_percentile_refuses_empty_input_and_bad_q():
    with pytest.raises(ValueError):
        percentile_linear(torch.zeros(0), 95.0)
    with pytest.raises(ValueError):
        percentile_linear(torch.zeros(3), 101.0)


def test_flow_p95_matches_the_reference_arithmetic():
    """`_flow_p95` with the flow module stubbed by a seeded 64x128 flow
    against the reference `p95_flow`'s arithmetic (magnitude, then
    `jnp.percentile` at 95), 1e-6 relative."""
    params = load_params_npz(QOCC + ".npz")
    flow_params = load_params_npz(QOCC + ".flow.npz")
    eng = FrameInterpolator(params, flow_params=flow_params, bf16=False,
                            device="cpu", dcn_max_offset=1, auto_scale=9.0)
    rng = np.random.default_rng(5)
    fl = (rng.standard_normal((2, 64, 128, 2)) * 6.0).astype(np.float32)
    eng.flow_module = lambda n0, n1: torch.from_numpy(fl)
    f = torch.zeros(2, 64, 128, 3)
    got = eng._flow_p95(f, f)
    fj = jnp.asarray(fl)
    mag = jnp.sqrt(jnp.square(fj[..., 0]) + jnp.square(fj[..., 1]))
    want = float(jnp.percentile(mag.astype(jnp.float32), 95.0))
    assert got == pytest.approx(want, rel=1e-6)
