"""vfi_tpu_torch.utils.convert: the tracked qocc checkpoint and its flow
net load into the port and map onto its modules' state dicts.
Layout tolerance: exact (a transpose); conv parity 1e-5 in float32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfi_tpu.utils.convert import infer_model_dims as jax_dims
from vfi_tpu.utils.convert import load_params_npz as jax_load
from vfi_tpu_torch.models import EMAVFI, SimpleFlowNet
from vfi_tpu_torch.utils.convert import (infer_model_dims, load_params_npz,
                                         params_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best")


@pytest.fixture(scope="module")
def trees():
    return load_params_npz(QOCC + ".npz"), load_params_npz(QOCC + ".flow.npz")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("suffix,n_keys", [(".npz", 42), (".flow.npz", 18)])
def test_load_matches_jax_loader(suffix, n_keys):
    ours = dict(_leaves(load_params_npz(QOCC + suffix)))
    ref = dict(_leaves(jax_load(QOCC + suffix)))
    assert len(ours) == n_keys
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_model_dims(trees):
    dims = infer_model_dims(trees[0])
    assert dims == jax_dims(trees[0])
    assert dims == {"in_channels": 3, "mid_channels": 64, "num_blocks": 3,
                    "fuse_project": True}


def test_emavfi_state_dict_loads_strict(trees):
    sd = params_from_jax(trees[0])
    assert len(sd) == 42
    model = EMAVFI(dcn_max_offset=1, warp_max_flow=16, fuse_project=True)
    ref = model.state_dict()
    assert sd.keys() == ref.keys()
    for k in sd:
        assert sd[k].shape == ref[k].shape, k
    model.load_state_dict(sd, strict=True)


def test_flownet_state_dict_loads_strict(trees):
    sd = params_from_jax(trees[1])
    assert len(sd) == 18
    SimpleFlowNet().load_state_dict(sd, strict=True)


@pytest.mark.parametrize("key", ["feat_ext_conv1/conv", "ctx_conv2/conv",
                                 "fusion_dcn1/offset_conv", "fusion_dcn2",
                                 "fuse_proj/conv", "rec_conv3/conv"])
def test_conv_layout_hwio_to_oihw(trees, key):
    node = trees[0]["params"]
    for part in key.split("/"):
        node = node[part]
    sd = params_from_jax(trees[0])
    tkey = key.replace("/", ".") + ".weight"
    np.testing.assert_array_equal(sd[tkey].numpy(),
                                  node["kernel"].transpose(3, 2, 0, 1))


def test_dense_layout_in_out_to_out_in(trees):
    sd = params_from_jax(trees[0])
    k = trees[0]["params"]["ctx_dense"]["kernel"]
    np.testing.assert_array_equal(sd["ctx_dense.weight"].numpy(), k.T)


def test_mapped_conv_matches_jax_conv(trees, rng):
    """The mapped weight computes the JAX conv: same input NHWC, HWIO
    kernel in JAX vs OIHW in torch."""
    k = trees[0]["params"]["motion_conv1"]["conv"]["kernel"]
    w = params_from_jax(trees[0])["motion_conv1.conv.weight"]
    x = rng.standard_normal((1, 12, 20, k.shape[2])).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, padding=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_unknown_leaf_raises():
    with pytest.raises(ValueError):
        params_from_jax({"params": {"a": {"scale": np.zeros(3)}}})
