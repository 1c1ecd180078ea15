"""The single conv's plain version (`conv2d_plain`, the reference of the
CUDA kernel `csrc/conv2d.cu`) against its TPU kernels, `conv2d_pallas`
(im2col and direct) and `conv2d_pallas_v2`, run in interpret mode on the
CPU in float32; the wrapper's CPU route, contract checks and weight
packing; the kernel's tile plan (`conv2d_plan`); and the one-layer chain,
which the kernel also runs on the card (`conv_chain` at L = 1): its CPU
route against `conv_chain_pallas` at L = 1 and its packing against
`pack_conv2d`. The kernel itself runs only on the card
(test_torch_cuda.py).

Tolerance: atol 2e-5, that of the JAX package's own conv tests
(tests/test_pallas_conv.py), with rtol 1e-5: both sides accumulate in
float32 in another order, and over 9 * 128 terms that moves the last
bits of an output of magnitude ~10 (2.6e-5 on one element of 32768)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfi_tpu.ops.pallas.conv import (conv2d_pallas, conv2d_pallas_v2,
                                    conv_chain_pallas)
from vfi_tpu_torch.ops.cuda import (conv2d, conv2d_plain, conv_chain,
                                    conv_chain_plain, launch_counts,
                                    pack_conv2d, pack_conv_chain,
                                    reset_launch_counts)
from vfi_tpu_torch.ops.cuda.conv import (H100_SMEM_PER_BLOCK, ROW_PAD,
                                         TILE_H, TILE_W, conv2d_plan)
from vfi_tpu_torch.tools.bench_conv import ALL_SHAPES


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, cin, cout, k, b=1, h=8, w=16):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    bs = rng.standard_normal((cout,)).astype(np.float32)
    return x, wt, bs


def _port(x, wt, bs, act, fn=conv2d_plain, **kw):
    return fn(t(x), t(wt.transpose(3, 2, 0, 1)),
              None if bs is None else t(bs), act, **kw).numpy()


@pytest.mark.parametrize("act,with_bias", [(True, True), (False, False)])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("cin,cout", [(6, 64), (64, 64), (64, 32)])
@pytest.mark.parametrize("variant", ["im2col", "direct"])
def test_conv2d_plain_matches_pallas_v1(rng, interpret_mode, variant, cin,
                                        cout, k, act, with_bias):
    x, wt, bs = _case(rng, cin, cout, k)
    bs = bs if with_bias else None
    ref = np.asarray(conv2d_pallas(
        jnp.asarray(x), jnp.asarray(wt),
        None if bs is None else jnp.asarray(bs), act=act, variant=variant))
    np.testing.assert_allclose(_port(x, wt, bs, act), ref, rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("act,with_bias", [(True, False), (False, True)])
@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64)])
def test_conv2d_plain_matches_pallas_v2(rng, interpret_mode, cin, cout, act,
                                        with_bias):
    # 16x32 gives v2 two row slabs and both packed parities at C=64
    x, wt, bs = _case(rng, cin, cout, 3, h=16, w=32)
    bs = bs if with_bias else None
    ref = np.asarray(conv2d_pallas_v2(
        jnp.asarray(x), jnp.asarray(wt),
        None if bs is None else jnp.asarray(bs), act=act))
    np.testing.assert_allclose(_port(x, wt, bs, act), ref, rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("variant", ["im2col", "direct", "v2"])
def test_conv2d_cpu_route_is_the_plain_version(rng, variant):
    x, wt, bs = _case(rng, 64, 16, 3)
    reset_launch_counts()
    got = _port(x, wt, bs, True, fn=conv2d, variant=variant)
    np.testing.assert_array_equal(got, _port(x, wt, bs, True))
    assert launch_counts()["conv2d"] == 0


@pytest.mark.parametrize("cin,w", [(6, 16), (67, 16), (64, 15)])
def test_conv2d_v2_keeps_its_refusals(cin, w):
    """"v2" is conv2d_pallas_v2's contract: C in {64, 128}, and W a
    multiple of 128 // C; the other variants take the shape."""
    x = torch.zeros(1, 4, w, cin)
    wt = torch.zeros(8, cin, 3, 3)
    with pytest.raises(ValueError):
        conv2d(x, wt, None, variant="v2")
    assert conv2d(x, wt, None, variant="im2col").shape == (1, 4, w, 8)


def test_conv2d_checks_its_arguments():
    x = torch.zeros(1, 4, 4, 16)
    for wt in (torch.zeros(8, 15, 3, 3), torch.zeros(8, 16, 2, 2),
               torch.zeros(8, 16, 3, 5)):
        with pytest.raises(ValueError):
            conv2d(x, wt)
    with pytest.raises(ValueError):
        conv2d(x, torch.zeros(8, 16, 3, 3), variant="chain")
    with pytest.raises(ValueError):
        conv2d(x[0], torch.zeros(8, 16, 3, 3))
    with pytest.raises(ValueError):
        conv2d(torch.empty(1, 4, 4, 16, device="meta"),
               torch.empty(8, 16, 3, 3, device="meta"))


@pytest.mark.parametrize("k", [1, 5])
def test_pack_conv2d_layout(rng, k):
    """[k*k * Cin16][Cout16] bf16, tap t = k*i + j, zero in the padded
    channels; the bias f32 of its bf16 values, zero-padded."""
    w = t(rng.standard_normal((27, 6, k, k)).astype(np.float32))
    b = t(rng.standard_normal((27,)).astype(np.float32))
    wpk, bpk = pack_conv2d(w, b)
    assert wpk.shape == (k * k * 16, 32) and wpk.dtype == torch.bfloat16
    blk = wpk.reshape(k, k, 16, 32)
    assert torch.equal(blk[:, :, :6, :27],
                       w.permute(2, 3, 1, 0).to(torch.bfloat16))
    assert not blk[:, :, 6:].any() and not blk[..., 27:].any()
    assert torch.equal(bpk[:27], b.to(torch.bfloat16).float())
    assert not bpk[27:].any()


# (Cin as the kernel receives it, Cout, k) of every conv the card runs:
# bench_conv's shapes; chip_smoke.py's other conv rows (k = 1 and 5) and
# its one-layer chain rows (64 -> 27, and 67 -> 27, padded to 72); the
# card tests' conv and one-layer chain shapes (tests/test_torch_cuda.py).
PLAN_SHAPES = sorted(
    {(max(8, -(-ci // 8) * 8), co, 3) for ci, co in ALL_SHAPES}
    | {(64, 32, 1), (64, 64, 5), (64, 27, 3), (72, 27, 3)}
    | {(64, 64, 3), (128, 64, 3), (64, 32, 3), (8, 64, 3), (16, 128, 1),
       (72, 5, 5), (24, 3, 7), (200, 40, 9), (72, 27, 3), (8, 16, 3),
       (24, 8, 3)})


@pytest.mark.parametrize("cin,cout,k", PLAN_SHAPES)
def test_conv2d_plan_fits_every_shape_the_card_runs(cin, cout, k):
    """Two input-tile buffers and the weights (resident, or two streamed
    tap groups) within an H100 block's 227 KB; every k = 3 layer keeps its
    whole weight set resident (one copy per block)."""
    p = conv2d_plan(cin, cout, k)
    cin16, cout16, taps = -(-cin // 16) * 16, -(-cout // 16) * 16, k * k
    tile = (TILE_H + k - 1) * (TILE_W + k - 1) * (p["ck"] + ROW_PAD) * 2
    wrow = (cout16 + ROW_PAD) * 2
    w_bytes = (taps * cin16 * wrow if p["resident"]
               else 2 * p["taps_per_group"] * p["ck"] * wrow)
    assert p["ck"] % 16 == 0 and p["ck"] <= cin16
    assert p["chunks"] == -(-cin16 // p["ck"])
    assert p["x_bytes"] % 128 == 0 and tile <= p["x_bytes"] < tile + 128
    assert p["smem_bytes"] == 2 * p["x_bytes"] + w_bytes
    assert p["smem_bytes"] <= H100_SMEM_PER_BLOCK
    assert p["groups"] * p["taps_per_group"] >= taps
    assert (p["groups"] - 1) * p["taps_per_group"] < taps
    if k == 3:
        assert p["resident"] and p["groups"] == 1


def test_conv2d_plan_streams_tap_groups_where_weights_do_not_fit():
    # 64 -> 64 at k = 5: 25 taps of weights (230 KB) do not fit beside the
    # tile; five groups of 5 taps double-buffered do
    p = conv2d_plan(64, 64, 5)
    assert not p["resident"] and (p["taps_per_group"], p["groups"]) == (5, 5)
    # 128 -> 64 at k = 3: resident weights (166 KB) beside a tile in four
    # 32-channel chunks
    p = conv2d_plan(128, 64, 3)
    assert p["resident"] and (p["ck"], p["chunks"]) == (32, 4)


@pytest.mark.parametrize("cin,cout,k,limit", [
    (16, 129, 3, H100_SMEM_PER_BLOCK), (16, 16, 11, H100_SMEM_PER_BLOCK),
    (16, 16, 4, H100_SMEM_PER_BLOCK), (16, 0, 3, H100_SMEM_PER_BLOCK),
    (64, 64, 3, 16 * 1024)])
def test_conv2d_plan_refuses_past_its_limits(cin, cout, k, limit):
    with pytest.raises(ValueError):
        conv2d_plan(cin, cout, k, limit)


@pytest.mark.parametrize("cin", [64, 67])
def test_one_layer_chain_packing_is_pack_conv2d(rng, cin):
    """The one-layer route launches the conv kernel on the chain's packed
    buffers: they equal `pack_conv2d`'s, flattened."""
    w = t((rng.standard_normal((27, cin, 3, 3)) * 0.1).astype(np.float32))
    b = t(rng.standard_normal((27,)).astype(np.float32))
    wc, bc = pack_conv_chain([w], [b])
    wk, bk = pack_conv2d(w, b)
    assert torch.equal(wc, wk.reshape(-1)) and torch.equal(bc, bk)
    assert torch.equal(wc.view(-1, 32), wk)


@pytest.mark.parametrize("cin,cout,act", [(64, 27, False), (67, 27, False),
                                          (3, 16, True), (24, 8, False)])
def test_one_layer_chain_cpu_route_is_the_plain_version(rng, interpret_mode,
                                                        cin, cout, act):
    """On the CPU a one-layer chain runs `conv_chain_plain` and launches
    nothing; that equals the single conv's plain version, and
    `conv_chain_pallas` at L = 1 (tolerance as the module's)."""
    x = rng.standard_normal((2, 8, 16, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    wt, bt = t(w.transpose(3, 2, 0, 1)), t(b)
    reset_launch_counts()
    got = conv_chain(t(x), [wt], [bt], (act,)).numpy()
    assert launch_counts()["conv_chain"] == 0
    np.testing.assert_array_equal(
        got, conv_chain_plain(t(x), [wt], [bt], (act,)).numpy())
    np.testing.assert_array_equal(got, conv2d_plain(t(x), wt, bt, act).numpy())
    ref = np.asarray(conv_chain_pallas(jnp.asarray(x), (jnp.asarray(w),),
                                       (jnp.asarray(b),), (act,)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
