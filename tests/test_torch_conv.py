"""The single conv's plain version (`conv2d_plain`, the reference of the
CUDA kernel `csrc/conv2d.cu`) against its TPU kernels, `conv2d_pallas`
(im2col and direct) and `conv2d_pallas_v2`, run in interpret mode on the
CPU in float32; the wrapper's CPU route, contract checks and weight
packing. The kernel itself runs only on the card (test_torch_cuda.py).

Tolerance: atol 2e-5, that of the JAX package's own conv tests
(tests/test_pallas_conv.py), with rtol 1e-5: both sides accumulate in
float32 in another order, and over 9 * 128 terms that moves the last
bits of an output of magnitude ~10 (2.6e-5 on one element of 32768)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfi_tpu.ops.pallas.conv import conv2d_pallas, conv2d_pallas_v2
from vfi_tpu_torch.ops.cuda import (conv2d, conv2d_plain, launch_counts,
                                    pack_conv2d, reset_launch_counts)


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
