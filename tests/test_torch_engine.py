"""`FrameInterpolator.midpoints` of the port vs `vfi_tpu`'s, the JAX
engine on a one-CPU-device mesh; flagship settings (qocc + flow prior,
cascade 2, R=1, warp bound 16) in float32, JAX matmuls at HIGHEST. Inputs
from numpy seeds. Tolerance 1e-4 on [0, 1] outputs."""

import os

import jax
import numpy as np
import pytest
import torch

from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.parallel import make_mesh
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.utils.convert import load_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
FLAGSHIP = dict(dcn_max_offset=1, warp_max_flow=16, cascade_levels=2)


@pytest.fixture(scope="module")
def qocc():
    return load_params_npz(QOCC + ".npz"), load_params_npz(QOCC + ".flow.npz")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    f0 = rng.uniform(0, 1, (3, 64, 128, 3)).astype(np.float32)
    f1 = np.roll(f0, (3, -4), axis=(1, 2))
    return f0, f1


@pytest.fixture(scope="module")
def jax_out(qocc, frames):
    with jax.default_matmul_precision("highest"):
        eng = JFI(qocc[0], flow_params=qocc[1], bf16=False, use_pallas=True,
                  dcn_kernel="v5", conv_kernel="pallas",
                  mesh=make_mesh(devices=jax.devices()[:1]), **FLAGSHIP)
        return np.asarray(eng.midpoints(*frames))


def _engine(qocc, **kw):
    return FrameInterpolator(qocc[0], flow_params=qocc[1], bf16=False,
                             device="cpu", **{**FLAGSHIP, **kw})


def test_midpoints_match_jax(qocc, frames, jax_out):
    got = _engine(qocc).midpoints(*frames)
    assert got.shape == (3, 64, 128, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-4, rtol=1e-4)


def test_pixel_guard_splits_launches_with_same_result(qocc, frames, jax_out):
    """max_px_per_launch = one pair: three launches, same midpoints."""
    eng = _engine(qocc, max_px_per_launch=64 * 128)
    got = eng.midpoints(*frames)
    np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-4, rtol=1e-4)


def test_midpoints_accept_tensors(qocc, frames, jax_out):
    f0, f1 = (torch.from_numpy(f) for f in frames)
    got = _engine(qocc).midpoints(f0[:1], f1[:1])
    np.testing.assert_allclose(got.numpy(), jax_out[:1], atol=1e-4, rtol=1e-4)


def test_without_flow_prior_matches_jax(qocc, frames):
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JFI(qocc[0], bf16=False,
                             mesh=make_mesh(devices=jax.devices()[:1]),
                             **FLAGSHIP).midpoints(frames[0][:1],
                                                   frames[1][:1]))
    got = FrameInterpolator(qocc[0], bf16=False, device="cpu",
                            **FLAGSHIP).midpoints(frames[0][:1],
                                                  frames[1][:1])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_bf16_engine_runs_on_cpu(qocc, frames, jax_out):
    got = FrameInterpolator(qocc[0], flow_params=qocc[1], bf16=True,
                            device="cpu", **FLAGSHIP).midpoints(
        frames[0][:1], frames[1][:1])
    assert torch.isfinite(got).all()
    assert 0.0 <= got.min().item() and got.max().item() <= 1.0
    assert np.abs(got.numpy() - jax_out[:1]).mean() < 2e-2


@pytest.mark.parametrize("kw", [dict(tta=True), dict(io_uint8=True),
                                dict(auto_scale=9.0), dict(spatial=True),
                                dict(mesh="data"),
                                dict(reference_compat=True)])
def test_unported_options_raise(qocc, kw):
    with pytest.raises(NotImplementedError):
        FrameInterpolator(qocc[0], device="cpu", dcn_max_offset=1, **kw)
