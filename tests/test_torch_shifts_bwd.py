"""The hand-written backward of the bounded DCN
(`ops.deform_conv_shifts.deform_conv2d_shifts_bwd`) against the JAX
function of that name (float32, JAX at HIGHEST precision) on offsets that
include integers, the clamp's ends and |offset| > R; against autograd of
the port's plain forward where the offsets avoid integers (the two differ
only there, by design); and the `ops.cuda.hand_backward()` swap on the
CPU route. Tolerance 5e-5: float32 sums of a few hundred terms in another
order (the JAX form sums 25 shifts a tap, this one four corners)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.ops.deform_conv_shifts import deform_conv2d_shifts_bwd as j_bwd
from vfi_tpu_torch.ops.cuda import deform_conv2d_bounded, hand_backward
from vfi_tpu_torch.ops.cuda.sampling import HandBackward
from vfi_tpu_torch.ops.deform_conv_shifts import (deform_conv2d_shifts,
                                                  deform_conv2d_shifts_bwd)

TOL = 5e-5
SHAPE = (2, 7, 9)          # B, H, W
CIN, COUT = 5, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(R: int, seed: int, integer_share: float = 0.3):
    """x, offset, mask, weight (HWIO), bias, cotangent as float32 numpy.
    Offsets in (-R - 1.5, R + 1.5); `integer_share` of them rounded to an
    integer (0 and +-R among them)."""
    rng = np.random.default_rng(seed)
    b, h, w = SHAPE
    x = rng.standard_normal((b, h, w, CIN)).astype(np.float32)
    off = rng.uniform(-R - 1.5, R + 1.5, (b, h, w, 18)).astype(np.float32)
    pick = rng.uniform(size=off.shape) < integer_share
    off[pick] = np.round(off[pick])
    mask = rng.uniform(0.0, 1.0, (b, h, w, 9)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, CIN, COUT)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(COUT).astype(np.float32)
    g = rng.standard_normal((b, h, w, COUT)).astype(np.float32)
    return x, off, mask, wt, bias, g


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def oihw(w):
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("masked", [True, False])
def test_hand_backward_matches_jax(R, masked):
    x, off, mask, wt, bias, g = inputs(R, seed=R)
    assert (off == 0).any() and (np.abs(off) == R).any()
    assert (np.abs(off) > R).any()
    m, bs = (mask, bias) if masked else (None, None)
    with jax.default_matmul_precision("highest"):
        ref = j_bwd(jnp.asarray(x), jnp.asarray(off),
                    None if m is None else jnp.asarray(m), jnp.asarray(wt),
                    None if bs is None else jnp.asarray(bs), jnp.asarray(g),
                    max_offset=R)
    got = deform_conv2d_shifts_bwd(t(x), t(off), None if m is None else t(m),
                                   t(oihw(wt)), None if bs is None else t(bs),
                                   t(g), max_offset=R)
    names = ("dx", "doffset", "dmask", "dweight", "dbias")
    for name, r, o in zip(names, ref, got):
        if r is None:
            assert o is None, name
            continue
        o = o.numpy()
        if name == "dweight":
            o = o.transpose(2, 3, 1, 0)
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, np.asarray(r), atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("R", [1, 2])
def test_hand_backward_is_autograd_of_the_plain_forward_off_integers(R):
    """Offsets at least 0.05 from an integer (and from +-R): the forward's
    floor is differentiable there, and autograd agrees with the tents."""
    x, off, mask, wt, bias, g = inputs(R, seed=10 + R, integer_share=0.0)
    frac = off - np.floor(off)
    off = np.floor(off) + np.clip(frac, 0.05, 0.95)
    leaves = [t(a).requires_grad_() for a in (x, off, mask, oihw(wt), bias)]
    deform_conv2d_shifts(*leaves, max_offset=R).backward(t(g))
    got = deform_conv2d_shifts_bwd(*(t(a) for a in (x, off, mask, oihw(wt),
                                                    bias, g)), max_offset=R)
    for leaf, o in zip(leaves, got):
        np.testing.assert_allclose(o.numpy(), leaf.grad.numpy(), atol=TOL,
                                   rtol=TOL)


def test_hand_backward_keeps_the_inputs_dtypes():
    x, off, mask, wt, bias, g = inputs(1, seed=5)
    bf = torch.bfloat16
    got = deform_conv2d_shifts_bwd(t(x).to(bf), t(off).to(bf),
                                   t(mask).to(bf), t(oihw(wt)), t(bias),
                                   t(g).to(bf), max_offset=1)
    assert [o.dtype for o in got] == [bf, bf, bf, torch.float32,
                                      torch.float32]


def _bounded_grads(args, R):
    leaves = [a.clone().requires_grad_() for a in args]
    out = deform_conv2d_bounded(*leaves[:4], leaves[4], R)
    return out, leaves


def test_hand_backward_swap_on_the_cpu_route():
    """Inside hand_backward() the wrapper's CPU route (the plain forward)
    records HandBackward, whose gradients are deform_conv2d_shifts_bwd's
    and, off integers, autograd's; outside it, autograd of the plain
    version; the swap is undone on exit, also on an exception, and a
    nested block leaves the outer one on."""
    R = 2
    x, off, mask, wt, bias, g = inputs(R, seed=21, integer_share=0.0)
    off = np.floor(off) + np.clip(off - np.floor(off), 0.05, 0.95)
    args = [t(a) for a in (x, off, mask, oihw(wt), bias)]
    with hand_backward():
        with hand_backward():
            pass
        out_h, leaves_h = _bounded_grads(args, R)
        assert type(out_h.grad_fn) is HandBackward._backward_cls
    out_h.backward(t(g))
    out_p, leaves_p = _bounded_grads(args, R)
    assert type(out_p.grad_fn) is not HandBackward._backward_cls
    out_p.backward(t(g))
    torch.testing.assert_close(out_h, out_p, atol=0, rtol=0)
    want = deform_conv2d_shifts_bwd(*args, t(g), max_offset=R)
    for lh, lp, w in zip(leaves_h, leaves_p, want):
        torch.testing.assert_close(lh.grad, w, atol=0, rtol=0)
        torch.testing.assert_close(lh.grad, lp.grad, atol=TOL, rtol=TOL)
    with pytest.raises(RuntimeError, match="inside"):
        with hand_backward():
            raise RuntimeError("inside")
    out, _ = _bounded_grads(args, R)
    assert type(out.grad_fn) is not HandBackward._backward_cls
    # no grad needed: no Function recorded at all
    with hand_backward():
        assert deform_conv2d_bounded(*args[:4], args[4], R).grad_fn is None
