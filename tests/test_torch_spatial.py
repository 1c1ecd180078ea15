"""The port's exact spatial halo pipeline over gloo ranks on the CPU
against the JAX package in float32: `spatial_interpolate` of the port
model over 2 and 4 ranks against JAX's one-device forward and JAX's
`spatial_interpolate` on `make_mesh(data=1, spatial=2|4)`, with the
conv-chain route layer by layer and the cascade; the engine's spatial
route against the JAX one-device engine, also over a 2 x 2 grid of
spatial groups with a data axis; a 116-row pair padded and cropped by the
engine against the JAX engine on the same edge-padded frames. The cases
of `tests/test_parallel.py`: 128x48 frames, R=1, warp
bound 2, halo 24, offset-conv biases jittered so that the DCNs and the
warp move rows. Tolerance rtol 2e-4, atol 2e-5, as there.

One module-scoped fixture spawns one 2-rank and one 4-rank gloo group
(workers in `tests/torch_dist_case.py`, torch only) that compute every
case once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_dist_case import run_ranks
from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.parallel import make_mesh as j_make_mesh
from vfi_tpu.parallel.spatial import spatial_interpolate as j_spatial
from vfi_tpu_torch.models import EMAVFI
from vfi_tpu_torch.parallel import spatial as t_spatial
from vfi_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-5)
BOUNDED = dict(dcn_max_offset=1, warp_max_flow=2)
WORLDS = (2, 4)


def _perturbed(w, mid_channels=64, num_blocks=3):
    """`tests/test_parallel.py`'s bounded model and params: JAX's init,
    the offset convs' biases jittered in [-1.5, 1.5]."""
    model = JEMAVFI(mid_channels=mid_channels, num_blocks=num_blocks,
                    **BOUNDED)
    f = jnp.zeros((1, 32, w, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), f, f)

    def jitter(path, x):
        name = "/".join(str(p.key) for p in path if hasattr(p, "key"))
        if "offset_conv" in name and name.endswith("bias"):
            k = jax.random.fold_in(jax.random.PRNGKey(7), len(name))
            return jax.random.uniform(k, x.shape, x.dtype, -1.5, 1.5)
        return x

    params = jax.tree_util.tree_map_with_path(jitter, params)
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    big, pbig = _perturbed(48)
    small, psmall = _perturbed(48, mid_channels=16, num_blocks=2)
    frames = {k: tuple(rng.uniform(0, 1, (b, h, 48, 3)).astype(np.float32)
                       for _ in range(2))
              for k, b, h in (("f2", 2, 128), ("f1", 1, 128),
                              ("f116", 2, 116), ("f3", 3, 128))}
    with jax.default_matmul_precision("highest"):
        cas = dataclasses.replace(big, cascade_levels=2)
        ref = {
            "plain": big.apply(pbig, *frames["f2"]),
            "pallas": big.apply(pbig, *frames["f1"]),
            "cascade": cas.apply(pbig, *frames["f2"]),
        }
        for n in WORLDS:
            ref[f"jax_spatial{n}"] = j_spatial(
                big, pbig, *map(jnp.asarray, frames["f2"]),
                j_make_mesh(data=1, spatial=n, devices=jax.devices()[:n]))
        eng = JFI(psmall, bf16=False, mesh=j_make_mesh(
            data=1, devices=jax.devices()[:1]), **BOUNDED)
        ref["engine"] = eng.midpoints(*frames["f2"])
        ref["grid"] = eng.midpoints(*frames["f3"])
        padded = [np.concatenate([f, np.repeat(f[:, -1:], 12, axis=1)], 1)
                  for f in frames["f116"]]
        ref["padded"] = np.asarray(eng.midpoints(*padded))[:, :116]
    ref = {k: np.asarray(v) for k, v in ref.items()}
    model_kw = dict(mid_channels=64, num_blocks=3, **BOUNDED)
    spec = {"big": params_from_jax(pbig), "small": psmall, **frames,
            "cases": [
                ("plain", "model", model_kw, "big", "f2"),
                ("pallas", "model", dict(model_kw, conv_kernel="pallas"),
                 "big", "f1"),
                ("cascade", "model", dict(model_kw, cascade_levels=2),
                 "big", "f2"),
                ("engine", "engine", BOUNDED, "small", "f2"),
                ("padded", "engine", BOUNDED, "small", "f116"),
                ("grid", "grid", BOUNDED, "small", "f3"),
            ]}
    got = {n: run_ranks("spatial_cases", n, spec)[0] for n in WORLDS}
    return ref, got


@pytest.mark.parametrize("name", ["plain", "pallas", "cascade"])
@pytest.mark.parametrize("world", WORLDS)
def test_spatial_forward_matches_jax_single_device(case, world, name):
    ref, got = case
    assert got[world][name].shape == ref[name].shape
    np.testing.assert_allclose(got[world][name], ref[name], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_forward_matches_jax_spatial_interpolate(case, world):
    ref, got = case
    np.testing.assert_allclose(got[world]["plain"],
                               ref[f"jax_spatial{world}"], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_spatial_route_matches_jax_engine(case, world):
    ref, got = case
    np.testing.assert_allclose(got[world]["engine"], ref["engine"], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_spatial_pads_misaligned_height(case, world):
    """116 rows pad to 128 (a multiple of 8 * ranks) and crop back: the
    JAX engine on the same edge-padded frames, cropped."""
    ref, got = case
    assert got[world]["padded"].shape == (2, 116, 48, 3)
    np.testing.assert_allclose(got[world]["padded"], ref["padded"], **TOL)


def test_engine_spatial_with_a_data_axis_matches_jax_engine(case):
    """4 ranks as two spatial groups of two (the data axis the infer CLI
    forms from the cards left): an odd batch of 3, padded to 4, one share
    a group, gathered."""
    ref, got = case
    assert got[4]["grid"].shape == (3, 128, 48, 3)
    np.testing.assert_allclose(got[4]["grid"], ref["grid"], **TOL)


@pytest.mark.parametrize("h,n,match", [(120, 4, "divide"), (64, 4, "exceeds"),
                                       (128, 2, None)])
def test_build_spatial_forward_checks_the_height(monkeypatch, h, n, match):
    """JAX's checks: H % (4 * ranks), the halo within the rows a rank
    owns (24 > 16 rows at 64 / 4); the unbounded model is refused."""
    monkeypatch.setattr(t_spatial.comm, "size", lambda g=None: n)
    model = EMAVFI(mid_channels=8, num_blocks=3, **BOUNDED)
    if match is None:
        fn = t_spatial.build_spatial_forward(model, h)
        assert (fn.halo, fn.h_local) == (24, 64)
    else:
        with pytest.raises(ValueError, match=match):
            t_spatial.build_spatial_forward(model, h)
    with pytest.raises(ValueError, match="bounded"):
        t_spatial.build_spatial_forward(EMAVFI(mid_channels=8), h)
