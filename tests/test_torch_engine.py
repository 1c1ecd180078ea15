"""`FrameInterpolator.midpoints` of the port vs `vfi_tpu`'s, the JAX
engine on a one-CPU-device mesh; flagship settings (qocc + flow prior,
cascade 2, R=1, warp bound 16) in float32, JAX matmuls at HIGHEST. Inputs
from numpy seeds. Tolerance 1e-4 on [0, 1] outputs, and on the auto_scale
probe (pixels) relative 1e-4. TTA and both auto_scale routes are held
against the JAX engine with the same options."""

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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_engine(qocc, **kw):
    return JFI(qocc[0], flow_params=qocc[1], bf16=False, use_pallas=True,
               mesh=make_mesh(devices=jax.devices()[:1]),
               **{**FLAGSHIP, **kw})


def test_tta_matches_jax(qocc, frames):
    """Identity, W-flip, H-flip and temporal swap, each through the flow
    prior, averaged in float32. Cascade 1 keeps the JAX compile of the four
    branches short; the cascade is held against JAX above."""
    f0, f1 = frames[0][:2], frames[1][:2]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_jax_engine(qocc, tta=True, cascade_levels=1)
                         .midpoints(f0, f1))
    eng = _engine(qocc, tta=True, cascade_levels=1)
    assert eng.max_px_per_launch == 2_000_000      # "auto" halves
    got = eng.midpoints(f0, f1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_scaled(qocc, frames):
    """The JAX engine with a threshold below the pair's p95 motion: the
    half-resolution route, and the probe it took."""
    with jax.default_matmul_precision("highest"):
        eng = _jax_engine(qocc, auto_scale=0.5)
        out = np.asarray(eng.midpoints(*frames))
    return out, eng.auto_scale_stats


def test_auto_scale_half_resolution_route_matches_jax(qocc, frames,
                                                      jax_scaled):
    ref, stats = jax_scaled
    assert stats["scaled"] == 1 and stats["probes"][0] > 0.5
    eng = _engine(qocc, auto_scale=0.5)
    got = eng.midpoints(*frames)
    assert eng.auto_scale_stats["scaled"] == 1
    np.testing.assert_allclose(eng.auto_scale_stats["probes"],
                               stats["probes"], rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_auto_scale_native_route_matches_jax(qocc, frames, jax_out,
                                             jax_scaled):
    """A threshold above the probe keeps the native route: the plain
    engine's midpoints, with the same probe recorded."""
    _, stats = jax_scaled
    eng = _engine(qocc, auto_scale=1e9)
    got = eng.midpoints(*frames)
    assert eng.auto_scale_stats["scaled"] == 0
    np.testing.assert_allclose(eng.auto_scale_stats["probes"],
                               stats["probes"], rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-4, rtol=1e-4)


def test_auto_scale_probes_once_per_call_on_the_first_chunk(qocc, frames):
    """The guard splits three pairs into launches of one; the probe sees
    the first chunk only, and decides for the whole call."""
    eng = _engine(qocc, auto_scale=1e9, max_px_per_launch=64 * 128)
    first = _engine(qocc, auto_scale=1e9)
    eng.midpoints(*frames)
    first.midpoints(frames[0][:1], frames[1][:1])
    assert eng.auto_scale_stats["probes"] == first.auto_scale_stats["probes"]


def test_auto_scale_needs_flow_params(qocc):
    with pytest.raises(ValueError):
        FrameInterpolator(qocc[0], device="cpu", dcn_max_offset=1,
                          auto_scale=9.0)


@pytest.mark.parametrize("kw", [
    dict(flow=True, match="flow-prior"),
    dict(io_uint8=True, match="io_uint8"),
    dict(tta=True, match="tta")])
def test_unported_options_raise(qocc, kw):
    """The JAX engine's refusals that remain with spatial sharding: the
    flow prior, io_uint8 and TTA (each with the JAX message)."""
    kw = dict(kw)
    flow, match = kw.pop("flow", False), kw.pop("match")
    with pytest.raises(ValueError, match=match):
        FrameInterpolator(qocc[0], flow_params=qocc[1] if flow else None,
                          device="cpu", dcn_max_offset=1, warp_max_flow=16,
                          spatial=True, **kw)
