"""The plain version of each ported CUDA kernel vs its TPU (Pallas)
kernel, run in interpret mode on the CPU, float32, at the shapes the JAX
package's own kernel tests use. Also the wrappers' CPU route and argument
checks (the kernels themselves run only on the card: test_torch_cuda.py).

Tolerances: conv chain 3e-5 (the JAX chain test's own); DCN 2e-4 and
warp 1e-4 (those of tests/test_pallas_sampling.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfi_tpu.ops.pallas.conv import conv_chain_pallas
from vfi_tpu.ops.pallas.sampling import (bounded_warp_pallas_v2,
                                         deform_conv2d_pallas_v5)
from vfi_tpu_torch.ops.cuda import (bounded_warp, bounded_warp_plain,
                                    conv_chain, conv_chain_plain,
                                    deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain,
                                    launch_counts, pack_conv_chain, pack_dcn,
                                    reset_launch_counts)


@pytest.fixture
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chain_case(rng, chans, b=2, h=8, w=32):
    x = rng.standard_normal((b, h, w, chans[0])).astype(np.float32)
    ws = [(rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [(rng.standard_normal((co,)) * 0.1).astype(np.float32)
          for co in chans[1:]]
    return x, ws, bs


@pytest.mark.parametrize("chans,acts", [
    ((64, 64, 64), (True, True)),
    ((128, 64, 64), (True, False)),
    ((64, 32, 4), (True, False)),
    ((64, 64, 64, 64), (True, True, True)),
])
def test_conv_chain_plain_matches_pallas(rng, interpret_mode, chans, acts):
    x, ws, bs = _chain_case(rng, chans)
    ref = np.asarray(conv_chain_pallas(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), acts))
    got = conv_chain_plain(t(x), [t(w.transpose(3, 2, 0, 1)) for w in ws],
                           [t(b) for b in bs], acts).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5)


def _dcn_case(rng, b, h, w, cin, cout, R, scale, wscale):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    off = np.clip(rng.standard_normal((b, h, w, 18)) * scale,
                  -R + 0.01, R - 0.01).astype(np.float32)
    mask = rng.uniform(0, 1, (b, h, w, 9)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * wscale).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return x, off, mask, wt, bias


@pytest.mark.parametrize("b,h,w,cin,cout,scale,wscale", [
    (2, 8, 16, 4, 5, 1.7, 0.3),
    (1, 8, 48, 67, 67, 1.2, 0.1),
    (1, 8, 48, 64, 64, 1.2, 0.1),
])
def test_dcn_plain_matches_pallas_v5(rng, interpret_mode, b, h, w, cin, cout,
                                     scale, wscale):
    R = 2
    x, off, mask, wt, bias = _dcn_case(rng, b, h, w, cin, cout, R, scale,
                                       wscale)
    ref = np.asarray(deform_conv2d_pallas_v5(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
        jnp.asarray(wt), jnp.asarray(bias), max_offset=R))
    got = deform_conv2d_bounded_plain(t(x), t(off), t(mask),
                                      t(wt.transpose(3, 2, 0, 1)), t(bias),
                                      R).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,R", [((1, 16, 24, 3), 4),
                                     ((2, 8, 140, 3), 16)])
def test_warp_plain_matches_pallas_v2(rng, interpret_mode, shape, R):
    b, h, w, c = shape
    img = rng.standard_normal(shape).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * R).astype(np.float32)
    ref = np.asarray(bounded_warp_pallas_v2(jnp.asarray(img),
                                            jnp.asarray(flow), max_flow=R))
    got = bounded_warp_plain(t(img), t(flow), R).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(rng):
    reset_launch_counts()
    x, ws, bs = _chain_case(rng, (16, 8, 3), b=1, h=5, w=7)
    tw = [t(w.transpose(3, 2, 0, 1)) for w in ws]
    acts = (True, False)
    assert torch.equal(conv_chain(t(x), tw, [t(b) for b in bs], acts),
                       conv_chain_plain(t(x), tw, [t(b) for b in bs], acts))
    xd, off, mask, wt, bias = _dcn_case(rng, 1, 5, 7, 4, 4, 1, 0.5, 0.3)
    args = (t(xd), t(off), t(mask), t(wt.transpose(3, 2, 0, 1)), t(bias))
    assert torch.equal(deform_conv2d_bounded(*args, 1, tile_w=128),
                       deform_conv2d_bounded_plain(*args, 1))
    img = t(rng.standard_normal((1, 5, 7, 3)).astype(np.float32))
    flow = t((rng.standard_normal((1, 5, 7, 2)) * 30).astype(np.float32))
    assert torch.equal(bounded_warp(img, flow, 16),
                       bounded_warp_plain(img, flow, 16))
    assert launch_counts() == {"conv_chain": 0, "deform_conv2d_bounded": 0,
                               "bounded_warp": 0}


def test_bounded_warp_plain_clips_the_flow(rng):
    img = t(rng.standard_normal((1, 6, 40, 3)).astype(np.float32))
    flow = torch.zeros(1, 6, 40, 2)
    flow[..., 0] = 25.0
    clipped = flow.clone()
    clipped[..., 0] = 16.0
    assert torch.equal(bounded_warp_plain(img, flow, 16),
                       bounded_warp_plain(img, clipped, 16))


@pytest.mark.parametrize("device", ["meta"])
def test_wrappers_refuse_other_devices(device):
    x = torch.empty(1, 4, 4, 16, device=device)
    w = torch.empty(16, 16, 3, 3, device=device)
    with pytest.raises(ValueError):
        conv_chain(x, [w], [None], (True,))
    with pytest.raises(ValueError):
        deform_conv2d_bounded(x, torch.empty(1, 4, 4, 18, device=device),
                              torch.empty(1, 4, 4, 9, device=device), w)
    with pytest.raises(ValueError):
        bounded_warp(torch.empty(1, 4, 4, 3, device=device),
                     torch.empty(1, 4, 4, 2, device=device))


def test_wrappers_check_shapes():
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError):
        conv_chain(x, [torch.zeros(8, 15, 3, 3)], [None], (True,))
    with pytest.raises(ValueError):
        conv_chain(x[0], [torch.zeros(8, 16, 3, 3)], [None], (True,))
    with pytest.raises(ValueError):
        deform_conv2d_bounded(x, torch.zeros(1, 4, 4, 16),
                              torch.zeros(1, 4, 4, 9),
                              torch.zeros(16, 16, 3, 3))
    with pytest.raises(ValueError):
        bounded_warp(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 5, 2))


def test_pack_conv_chain_layout(rng):
    """Per layer a [9][cin_p][cout_p] bf16 block, tap t = 3i + j, zero in
    the padded channels; biases f32 of their bf16 values, zero-padded."""
    chans = (16, 27, 3)
    ws = [t(rng.standard_normal((co, ci, 3, 3)).astype(np.float32))
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [t(rng.standard_normal((co,)).astype(np.float32)) for co in chans[1:]]
    wpk, bpk = pack_conv_chain(ws, bs)
    assert wpk.dtype == torch.bfloat16 and bpk.dtype == torch.float32
    blocks = torch.split(wpk, [9 * 16 * 32, 9 * 32 * 16])
    for blk, w, cin_p, cout_p in zip(blocks, ws, (16, 32), (32, 16)):
        blk = blk.reshape(3, 3, cin_p, cout_p)
        cout, cin = w.shape[:2]
        assert torch.equal(blk[:, :, :cin, :cout],
                           w.permute(2, 3, 1, 0).to(torch.bfloat16))
        assert not blk[:, :, cin:].any() and not blk[..., cout:].any()
    b0, b1 = torch.split(bpk, [32, 16])
    for got, b in ((b0, bs[0]), (b1, bs[1])):
        assert torch.equal(got[:b.numel()], b.to(torch.bfloat16).float())
        assert not got[b.numel():].any()


def test_pack_dcn_layout(rng):
    w = t(rng.standard_normal((32, 16, 3, 3)).astype(np.float32))
    wpk, bpk = pack_dcn(w, None)
    assert wpk.shape == (9 * 16, 32) and wpk.dtype == torch.bfloat16
    assert torch.equal(wpk.reshape(3, 3, 16, 32),
                       w.permute(2, 3, 1, 0).to(torch.bfloat16))
    assert bpk.dtype == torch.float32 and not bpk.any()
