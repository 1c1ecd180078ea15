"""The 67-channel reference topology (no `fuse_proj`: the fusion stack is
64 features + RGB wide) through the port's engine vs `vfi_tpu`'s: the
tracked q12 checkpoint at R=2, cascade 2 and the flow prior, 64x128, in
float32 with JAX matmuls at HIGHEST. Tolerance 1e-4 on [0, 1] outputs
(as tests/test_torch_engine.py). Both `conv_kernel` settings compute the
same function on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.parallel import make_mesh
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.utils.convert import infer_model_dims, load_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q12 = os.path.join(REPO, "artifacts", "emavfi_q12_best")
KW = dict(dcn_max_offset=2, warp_max_flow=16, cascade_levels=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def q12():
    return load_params_npz(Q12 + ".npz"), load_params_npz(Q12 + ".flow.npz")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(12)
    f0 = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    return f0, np.roll(f0, (3, -4), axis=(1, 2))


@pytest.fixture(scope="module")
def jax_out(q12, frames):
    with jax.default_matmul_precision("highest"):
        eng = JFI(q12[0], flow_params=q12[1], bf16=False, use_pallas=True,
                  mesh=make_mesh(devices=jax.devices()[:1]), **KW)
        return np.asarray(eng.midpoints(*frames))


def test_q12_is_the_67_channel_topology(q12):
    dims = infer_model_dims(q12[0])
    assert not dims["fuse_project"] and dims["mid_channels"] == 64
    assert q12[0]["params"]["fusion_dcn0"]["kernel"].shape == (3, 3, 67, 67)


@pytest.mark.parametrize("conv_kernel", ["xla", "pallas"])
def test_q12_midpoints_match_jax(q12, frames, jax_out, conv_kernel):
    eng = FrameInterpolator(q12[0], flow_params=q12[1], bf16=False,
                            conv_kernel=conv_kernel,
                            device="cpu", **KW)
    got = eng.midpoints(*frames)
    assert got.shape == (2, 64, 128, 3)
    np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-4, rtol=1e-4)
