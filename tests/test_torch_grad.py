"""The kernel wrappers' autograd Functions, their forward given the plain
op on the CPU, against `jax.grad` through the reference's `custom_vjp`
wrappers (`vfi_tpu/ops/pallas/wrappers.py`: `conv2d_fast`,
`deform_conv2d_fast`, `warp_fast`, `conv_chain_fast`), whose Pallas
forwards run in interpret mode; float32. On the card the same Functions
wrap the kernel launches (test_torch_cuda.py holds those gradients to the
plain versions').

Tolerances: the conv's closed-form backward and the chain's recomputed
one are float32 convolutions on both sides, 1e-4; the DCN and warp
backward differentiate two formulations of one function (the shift
decomposition there, the gather here), 2e-4 as their forwards
(tests/test_pallas_sampling.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfi_tpu.ops.pallas.wrappers import (conv2d_fast, conv_chain_fast,
                                         deform_conv2d_fast, warp_fast)
from vfi_tpu_torch.ops.cuda import (bounded_warp_plain, conv2d_plain,
                                    conv_chain_plain,
                                    deform_conv2d_bounded_plain)
from vfi_tpu_torch.ops.cuda.conv import Conv2dFunction
from vfi_tpu_torch.ops.cuda.grad import ThroughPlain


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


def oihw(w):
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def hwio(g):
    return g.permute(2, 3, 1, 0).numpy()


def port_grads(fn, args, g):
    """Gradients of sum(fn(*args) * g) w.r.t. every non-None arg."""
    leaves = [None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).requires_grad_() for a in args]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return [None if a is None else a.grad for a in leaves]


def jax_grads(fn, args, g):
    live = [i for i, a in enumerate(args) if a is not None]

    def f(*xs):
        full = list(args)
        for i, x in zip(live, xs):
            full[i] = x
        return jnp.sum(fn(*full) * g)

    gs = jax.grad(f, argnums=tuple(range(len(live))))(
        *[jnp.asarray(args[i]) for i in live])
    out = [None] * len(args)
    for i, gi in zip(live, gs):
        out[i] = np.asarray(gi)
    return out


@pytest.mark.parametrize("act,with_bias", [(True, True), (False, True),
                                           (True, False)])
def test_conv2d_function_backward_matches_jax(rng, interpret_mode, act,
                                              with_bias):
    x = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    bs = rng.standard_normal((8,)).astype(np.float32) if with_bias else None
    g = rng.standard_normal((2, 8, 16, 8)).astype(np.float32)
    ref = jax_grads(lambda a, w, b: conv2d_fast(a, w, b, act), [x, wt, bs],
                    g)
    got = port_grads(lambda a, w, b: Conv2dFunction.apply(
        lambda a, w, b: conv2d_plain(a, w, b, act), act, a, w, b),
        [x, oihw(wt), bs], g)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hwio(got[1]), ref[1], rtol=1e-4, atol=1e-4)
    if with_bias:
        np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=1e-4,
                                   atol=1e-4)


def test_conv_chain_function_backward_matches_jax(rng, interpret_mode):
    chans, acts = (64, 32, 8), (True, False)
    x = rng.standard_normal((1, 8, 32, 64)).astype(np.float32)
    ws = [(rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [(rng.standard_normal((co,)) * 0.1).astype(np.float32)
          for co in chans[1:]]
    g = rng.standard_normal((1, 8, 32, 8)).astype(np.float32)
    ref = jax_grads(lambda a, w0, w1, b0, b1: conv_chain_fast(
        a, (w0, w1), (b0, b1), acts), [x, *ws, *bs], g)

    def plain(a, *p):
        return conv_chain_plain(a, p[:2], p[2:], acts)

    got = port_grads(lambda *a: ThroughPlain.apply(plain, plain, *a),
                     [x, *map(oihw, ws), *bs], g)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-4, atol=1e-4)
    for i in (1, 2):
        np.testing.assert_allclose(hwio(got[i]), ref[i], rtol=1e-4,
                                   atol=1e-4)
    for i in (3, 4):
        np.testing.assert_allclose(got[i].numpy(), ref[i], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("with_mask", [True, False])
def test_dcn_function_backward_matches_jax(rng, interpret_mode, with_mask):
    R, c = 2, 8
    x = rng.standard_normal((1, 8, 16, c)).astype(np.float32)
    off = np.clip(rng.standard_normal((1, 8, 16, 18)) * 1.4, -R + 0.01,
                  R - 0.01).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, 8, 16, 9)).astype(np.float32)
            if with_mask else None)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.3).astype(np.float32)
    bs = rng.standard_normal((c,)).astype(np.float32)
    g = rng.standard_normal((1, 8, 16, c)).astype(np.float32)
    ref = jax_grads(lambda *a: deform_conv2d_fast(*a, max_offset=R),
                    [x, off, mask, wt, bs], g)

    def plain(*a):
        return deform_conv2d_bounded_plain(*a, R)

    got = port_grads(lambda *a: ThroughPlain.apply(plain, plain, *a),
                     [x, off, mask, oihw(wt), bs], g)
    for i in (0, 1, 2, 4):
        if ref[i] is not None:
            np.testing.assert_allclose(got[i].numpy(), ref[i], rtol=2e-4,
                                       atol=2e-4)
    np.testing.assert_allclose(hwio(got[3]), ref[3], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("c", [3, 16])
def test_warp_function_backward_matches_jax(rng, interpret_mode, c):
    """Flows reach past R: the clip's gradient is 0 there on both sides."""
    R = 3
    img = rng.standard_normal((1, 8, 24, c)).astype(np.float32)
    flow = (rng.standard_normal((1, 8, 24, 2)) * 2.0).astype(np.float32)
    g = rng.standard_normal((1, 8, 24, c)).astype(np.float32)
    ref = jax_grads(lambda i, f: warp_fast(i, f, R), [img, flow], g)

    def plain(i, f):
        return bounded_warp_plain(i, f, R)

    got = port_grads(lambda *a: ThroughPlain.apply(plain, plain, *a),
                     [img, flow], g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-4)


def test_wrappers_carry_autograd_on_the_cpu(rng):
    """On the CPU the wrappers run the plain versions, which autograd
    differentiates directly: every output has a grad_fn when an input
    requires grad."""
    from vfi_tpu_torch.ops.cuda import (bounded_warp, conv2d, conv_chain,
                                        deform_conv2d_bounded)

    x = torch.randn(1, 5, 7, 8, requires_grad=True)
    w = torch.randn(4, 8, 3, 3, requires_grad=True)
    outs = [conv2d(x, w, None, True), conv_chain(x, [w], [None], (True,)),
            deform_conv2d_bounded(x, torch.randn(1, 5, 7, 18), None, w),
            bounded_warp(x, torch.randn(1, 5, 7, 2))]
    assert all(o.grad_fn is not None for o in outs)
