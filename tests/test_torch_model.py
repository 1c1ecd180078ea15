"""Models of the port vs `vfi_tpu`, float32 on both sides, JAX matmuls at
HIGHEST precision, inputs from numpy seeds. The flagship EMAVFI runs with
the tracked qocc weights at 64x128 (cascade 2, R=1, warp bound 16, the
flow prior's pre-warped frame). Tolerance 1e-4: ~20 layers of f32 convs
summed in another order; the models' outputs are in [0, 1]."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.models.flownet import SimpleFlowNet as JFlowNet
from vfi_tpu.models.layers import ModulatedDeformConv as JMDC
from vfi_tpu.models.layers import apply_conv_chain as j_chain
from vfi_tpu.models.prior import prior_prewarp as j_prior
from vfi_tpu_torch.models import EMAVFI, SimpleFlowNet, prior_prewarp
from vfi_tpu_torch.models.layers import (ConvBlock, ModulatedDeformConv,
                                         apply_conv_chain)
from vfi_tpu_torch.ops.cuda import pack_conv_chain, pack_dcn
from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
TOL = 1e-4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def qocc():
    return load_params_npz(QOCC + ".npz"), load_params_npz(QOCC + ".flow.npz")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    f0 = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    f1 = np.roll(f0, (2, 3), axis=(1, 2))
    return f0, f1


def _torch_flownet(flow_tree):
    net = SimpleFlowNet()
    net.load_state_dict(params_from_jax(flow_tree))
    return net.eval()


def test_flownet_matches_jax(qocc, pair):
    f0, f1 = pair
    with jax.default_matmul_precision("highest"):
        ref = JFlowNet().apply(qocc[1], jnp.asarray(f0), jnp.asarray(f1))
    with torch.no_grad():
        got = _torch_flownet(qocc[1])(t(f0), t(f1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_prior_prewarp_matches_jax(qocc, pair):
    f0, f1 = pair
    with jax.default_matmul_precision("highest"):
        ref, ref_flow = j_prior(lambda a, b: JFlowNet().apply(qocc[1], a, b),
                                jnp.asarray(f0), jnp.asarray(f1))
    with torch.no_grad():
        got, flow = prior_prewarp(_torch_flownet(qocc[1]), t(f0), t(f1))
    np.testing.assert_allclose(flow.numpy(), np.asarray(ref_flow), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("cascade", [1, 2])
def test_emavfi_qocc_matches_jax(qocc, pair, cascade, use_kernels):
    f0, f1 = pair
    kw = dict(dcn_max_offset=1, warp_max_flow=16, cascade_levels=cascade,
              fuse_project=True)
    with jax.default_matmul_precision("highest"):
        ref = JEMAVFI(use_pallas=True, dcn_kernel="v5", conv_kernel="pallas",
                      **kw).apply(qocc[0], jnp.asarray(f0), jnp.asarray(f1))
    model = EMAVFI(use_kernels=use_kernels, **kw)
    model.load_state_dict(params_from_jax(qocc[0]))
    with torch.no_grad():
        got = model.eval()(t(f0), t(f1))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_emavfi_unbounded_warp_matches_jax(qocc, pair):
    f0, f1 = pair
    kw = dict(dcn_max_offset=1, warp_max_flow=None, fuse_project=True)
    with jax.default_matmul_precision("highest"):
        ref = JEMAVFI(**kw).apply(qocc[0], jnp.asarray(f0), jnp.asarray(f1))
    model = EMAVFI(**kw)
    model.load_state_dict(params_from_jax(qocc[0]))
    with torch.no_grad():
        got = model.eval()(t(f0), t(f1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_emavfi_bf16_runs_near_f32(qocc, pair):
    """bf16 activations (the card's mode) stay close to f32 on CPU."""
    f0, f1 = pair
    kw = dict(dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
              fuse_project=True)
    outs = []
    for dt in (None, torch.bfloat16):
        model = EMAVFI(dtype=dt, **kw)
        model.load_state_dict(params_from_jax(qocc[0]))
        with torch.no_grad():
            outs.append(model.eval()(t(f0), t(f1)))
    assert outs[1].dtype == torch.float32
    assert (outs[1] - outs[0]).abs().mean().item() < 2e-2


@pytest.mark.parametrize("chans,acts", [((64, 64, 64, 64), (True,) * 3),
                                        ((128, 64, 64, 2), (True, True, False)),
                                        ((64, 27), (False,))])
def test_apply_conv_chain_matches_jax(rng, chans, acts):
    x = rng.standard_normal((1, 9, 14, chans[0])).astype(np.float32)
    kbs = [((rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32),
            (rng.standard_normal((co,)) * 0.1).astype(np.float32))
           for ci, co in zip(chans[:-1], chans[1:])]
    with jax.default_matmul_precision("highest"):
        ref = j_chain(jnp.asarray(x), [(jnp.asarray(k), jnp.asarray(b))
                                       for k, b in kbs], acts)
    blocks = []
    for k, b in kbs:
        blk = ConvBlock(k.shape[2], k.shape[3])
        blk.conv.weight.data = t(k.transpose(3, 2, 0, 1))
        blk.conv.bias.data = t(b)
        blocks.append(blk)
    with torch.no_grad():
        got = apply_conv_chain(t(x), blocks, acts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("R", [1, 2])
def test_modulated_deform_conv_matches_jax(rng, R):
    """Random (non-zero) offset-conv weights, so offsets and masks vary:
    the static | mask | dynamic split and the (dy, dx) order are checked."""
    c = 16
    x = rng.standard_normal((1, 10, 12, c)).astype(np.float32)
    jm = JMDC(c, max_offset=R)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(np.asarray, params)
    p["params"]["offset_conv"]["kernel"] = (
        rng.standard_normal((3, 3, c, 27)) * 0.3).astype(np.float32)
    p["params"]["offset_conv"]["bias"] = (
        rng.standard_normal((27,)) * 0.3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jm.apply(p, jnp.asarray(x))
    tm = ModulatedDeformConv(c, R)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tm(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError):
        EMAVFI(dcn_max_offset=None)
    with pytest.raises(NotImplementedError):
        EMAVFI(dcn_max_offset=1, spatial_axis="spatial")
    with pytest.raises(ValueError):
        EMAVFI(dcn_max_offset=1, cascade_levels=0)


def test_pack_kernel_weights_holds_every_chain_and_dcn(qocc):
    """The engine packs once: three chains and each DCN's offset conv and
    weights, each pack equal to packing the live weights on a call."""
    model = EMAVFI(dcn_max_offset=1, warp_max_flow=16, fuse_project=True)
    model.load_state_dict(params_from_jax(qocc[0]))
    model.pack_kernel_weights()
    assert set(model.packed) == {model.feat_chain, model.MOTION_CHAIN,
                                 model.REC_CHAIN}
    rec = [getattr(model, n).conv for n in model.REC_CHAIN]
    for got, ref in zip(model.packed[model.REC_CHAIN],
                        pack_conv_chain([c.weight for c in rec],
                                        [c.bias for c in rec])):
        assert torch.equal(got, ref)
    for i in range(model.num_blocks):
        dcn = getattr(model, f"fusion_dcn{i}")
        assert torch.equal(dcn.packed[1][0],
                           pack_dcn(dcn.weight, dcn.bias)[0])
        assert dcn.packed[0][0].numel() == 9 * 64 * 32
