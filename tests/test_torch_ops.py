"""Plain ops of the port vs their `vfi_tpu` counterparts, float32 on both
sides, inputs from numpy seeds. Tolerances: warp 1e-5 (same f32
arithmetic); resize 1e-5 (HIGHEST-precision matmuls); bounded DCN 1e-4
(f32 sums of up to 9 * Cin terms in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfi_tpu.ops import deform_conv2d as jax_dcn_exact
from vfi_tpu.ops import warp as jax_warp
from vfi_tpu.ops.deform_conv_shifts import deform_conv2d_shifts as jax_shifts
from vfi_tpu.ops.resize import resize_bilinear as jax_resize
from vfi_tpu_torch.ops import deform_conv2d_shifts, resize_bilinear, warp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,scale", [((1, 9, 13, 3), 2.0),
                                         ((2, 16, 24, 3), 6.0),
                                         ((1, 7, 11, 8), 30.0),
                                         ((2, 2, 2, 1), 1.5)])
def test_warp_matches_jax(rng, shape, scale):
    b, h, w, c = shape
    img = rng.standard_normal(shape).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)
    ref = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = warp(t(img), t(flow)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_warp_integer_flow_is_a_shift(rng):
    img = rng.standard_normal((1, 6, 9, 3)).astype(np.float32)
    flow = np.zeros((1, 6, 9, 2), np.float32)
    flow[..., 0] = 2.0
    got = warp(t(img), t(flow)).numpy()
    np.testing.assert_array_equal(got[:, :, :7], img[:, :, 2:])
    np.testing.assert_array_equal(got[:, :, 7:], 0.0)


@pytest.mark.parametrize("src,dst", [((16, 24), (8, 12)), ((9, 13), (20, 7)),
                                     ((32, 64), (16, 32)), ((5, 5), (5, 5)),
                                     ((8, 12), (16, 24))])
def test_resize_matches_jax_and_interpolate(rng, src, dst):
    img = rng.standard_normal((2,) + src + (3,)).astype(np.float32)
    got = resize_bilinear(t(img), dst).numpy()
    ref = np.asarray(jax_resize(jnp.asarray(img), dst))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    tv = F.interpolate(t(img).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                       align_corners=False, antialias=False)
    np.testing.assert_allclose(got, tv.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5, rtol=1e-5)


def _dcn_case(rng, b, h, w, cin, cout, spread, mask=True):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    off = (rng.standard_normal((b, h, w, 18)) * spread).astype(np.float32)
    m = rng.uniform(0, 1, (b, h, w, 9)).astype(np.float32) if mask else None
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return x, off, m, wt, bias


def _torch_dcn(x, off, m, wt, bias, R):
    return deform_conv2d_shifts(
        t(x), t(off), None if m is None else t(m),
        t(wt.transpose(3, 2, 0, 1)), t(bias), max_offset=R).numpy()


@pytest.mark.parametrize("R,spread,mask", [(1, 1.0, True), (2, 1.5, True),
                                           (1, 0.4, False), (3, 2.5, True)])
def test_bounded_dcn_matches_jax_shifts(rng, R, spread, mask):
    """Offsets spread past R: the clamp is part of the function."""
    x, off, m, wt, bias = _dcn_case(rng, 2, 8, 12, 8, 6, spread, mask)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_shifts(
            jnp.asarray(x), jnp.asarray(off),
            None if m is None else jnp.asarray(m), jnp.asarray(wt),
            jnp.asarray(bias), max_offset=R))
    np.testing.assert_allclose(_torch_dcn(x, off, m, wt, bias, R), ref,
                               atol=1e-4, rtol=1e-4)


def test_bounded_dcn_equals_exact_in_range(rng):
    """For offsets inside [-R, R] the bounded op is the exact DCNv2."""
    x, off, m, wt, bias = _dcn_case(rng, 1, 7, 10, 4, 5, 0.5)
    off = np.clip(off, -0.99, 0.99)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_dcn_exact(jnp.asarray(x), jnp.asarray(off),
                                       jnp.asarray(m), jnp.asarray(wt),
                                       jnp.asarray(bias)))
    np.testing.assert_allclose(_torch_dcn(x, off, m, wt, bias, 1), ref,
                               atol=1e-4, rtol=1e-4)


def test_bounded_dcn_zero_offset_is_conv(rng):
    """Zero offsets and unit mask: a plain 3x3 zero-padded conv."""
    x, off, m, wt, bias = _dcn_case(rng, 1, 6, 9, 5, 4, 0.0)
    m = np.ones_like(m)
    ref = F.conv2d(t(x).permute(0, 3, 1, 2), t(wt.transpose(3, 2, 0, 1)),
                   t(bias), padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(_torch_dcn(x, off * 0, m, wt, bias, 1), ref,
                               atol=1e-5, rtol=1e-5)


def test_bounded_dcn_bf16_holds_samples_in_bf16(rng):
    """bf16 inputs: f32 blends, sample matrix rounded to bf16, one f32
    contraction, output rounded once — equal to the f32 op run on the
    bf16-rounded samples (within one bf16 ulp of the output)."""
    x, off, m, wt, bias = _dcn_case(rng, 1, 6, 8, 16, 16, 0.7)
    xb = t(x).bfloat16()
    got = deform_conv2d_shifts(xb, t(off).bfloat16(), t(m).bfloat16(),
                               t(wt.transpose(3, 2, 0, 1)), t(bias),
                               max_offset=1)
    assert got.dtype == torch.bfloat16
    ref = deform_conv2d_shifts(xb.float(), t(off).bfloat16().float(),
                               t(m).bfloat16().float(),
                               t(wt.transpose(3, 2, 0, 1)).bfloat16().float(),
                               t(bias).bfloat16().float(), max_offset=1)
    err = (got.float() - ref).abs().max().item()
    assert err <= 2 ** -6 * ref.abs().max().item()
