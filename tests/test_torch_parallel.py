"""The port's mesh and halo contract against `vfi_tpu.parallel`:
`make_mesh` shapes and errors against JAX's on the fake CPU devices,
`required_halo` over a grid of models and its refusal of unbounded
sampling, `shard_batch`, and the spatial mode's row masks against the JAX
model's `_row_tools` run inside a `shard_map`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.parallel import make_mesh as j_make_mesh
from vfi_tpu.parallel import required_halo as j_required_halo
from vfi_tpu_torch.models import EMAVFI
from vfi_tpu_torch.models import ema_vfi
from vfi_tpu_torch.parallel import make_mesh, required_halo, shard_batch

CPU = torch.device("cpu")


@pytest.mark.parametrize("data,spatial", [(-1, 1), (-1, 2), (-1, 4), (2, 2),
                                          (1, 8), (3, 2), (8, 1)])
def test_make_mesh_shapes_match_jax(data, spatial):
    ref = j_make_mesh(data, spatial)
    got = make_mesh(data, spatial, devices=[CPU] * 8)
    assert got.shape == dict(ref.shape)
    assert len(got.data_devices) == ref.shape["data"]


@pytest.mark.parametrize("data,spatial", [(16, 1), (-1, 3), (3, 3), (1, 0),
                                          (-1, -2)])
def test_make_mesh_errors_match_jax(data, spatial):
    with pytest.raises(ValueError) as ref:
        j_make_mesh(data, spatial)
    with pytest.raises(ValueError) as got:
        make_mesh(data, spatial, devices=[CPU] * 8)
    assert str(got.value) == str(ref.value)


def test_make_mesh_default_takes_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = make_mesh()
    assert mesh.shape == {"data": 3, "spatial": 1}
    assert mesh.data_devices == tuple(torch.device("cuda", i)
                                      for i in range(3))


def test_shard_batch_splits_over_data():
    mesh = make_mesh(4, 2, devices=[CPU] * 8)
    x = np.arange(8 * 2 * 3).reshape(8, 2, 3).astype(np.float32)
    y = torch.arange(8)
    parts = shard_batch((x, y), mesh)
    assert len(parts) == 4
    for i, (px, py) in enumerate(parts):
        np.testing.assert_array_equal(px.numpy(), x[2 * i:2 * i + 2])
        assert py.tolist() == [2 * i, 2 * i + 1]
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch((x[:6],), mesh)


@pytest.mark.parametrize("num_blocks", [1, 2, 3])
@pytest.mark.parametrize("R", [1, 2, 8])
@pytest.mark.parametrize("warp", [2, 16])
def test_required_halo_matches_jax(num_blocks, R, warp):
    assert required_halo(num_blocks, R, warp) == j_required_halo(
        num_blocks, R, warp)


@pytest.mark.parametrize("R,warp", [(None, 16), (1, None), (None, None)])
def test_required_halo_refuses_unbounded_sampling(R, warp):
    with pytest.raises(ValueError, match="bounded"):
        j_required_halo(3, R, warp)
    with pytest.raises(ValueError, match="bounded"):
        required_halo(3, R, warp)


@pytest.mark.parametrize("n,global_h,halo", [(2, 64, 8), (4, 64, 8),
                                             (2, 96, 24), (4, 128, 24)])
def test_row_masks_match_jax(monkeypatch, n, global_h, halo):
    """`mask` at scales 1, 2, 4 and `owner_mask` at 2 and 4 of each rank's
    slab, against the JAX model's inside a shard_map over n fake devices
    (the port's rank and size patched in)."""
    h_local = global_h // n
    slab = h_local + 2 * halo
    jm = JEMAVFI(dcn_max_offset=1, warp_max_flow=2, spatial_axis="spatial",
                 spatial_halo=halo, spatial_global_h=global_h)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("spatial",))
    cases = [("mask", 1), ("mask", 2), ("mask", 4), ("owner", 2),
             ("owner", 4)]

    def body(x):
        mask, owner = jm._row_tools()
        outs = []
        for kind, sc in cases:
            xs = x[:, :slab // sc]
            outs.append(mask(xs, sc) if kind == "mask" else owner(xs, sc))
        return tuple(outs)

    ones = jnp.ones((1, n * slab, 1, 1), jnp.float32)
    refs = jax.shard_map(body, mesh=mesh, in_specs=P(None, "spatial"),
                         out_specs=(P(None, "spatial"),) * len(cases))(ones)
    model = EMAVFI(dcn_max_offset=1, warp_max_flow=2).with_spatial(
        None, halo, global_h)
    monkeypatch.setattr(ema_vfi.comm, "size", lambda g=None: n)
    for r in range(n):
        monkeypatch.setattr(ema_vfi.comm, "rank", lambda g=None, r=r: r)
        mask, owner = model._row_tools()
        for (kind, sc), ref in zip(cases, refs):
            rows = slab // sc
            x = torch.ones(1, rows, 1, 1)
            got = mask(x, sc) if kind == "mask" else owner(x, sc)
            want = np.asarray(ref)[:, r * rows:(r + 1) * rows]
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{kind} {sc} rank {r}")


def test_with_spatial_shares_the_weights():
    m = EMAVFI(dcn_max_offset=1, warp_max_flow=2, conv_kernel="pallas")
    m.pack_kernel_weights()
    sp = m.with_spatial(None, 24, 128)
    assert m.spatial_global_h is None and sp.spatial_global_h == 128
    assert sp.spatial_halo == 24 and sp.spatial_group is None
    assert sp.ctx_dense.weight is m.ctx_dense.weight
    assert ("motion_conv1",) in sp.packed and ("motion_conv1",) not in \
        m.packed
    assert torch.equal(sp.packed[m.MOTION_CHAIN][0],
                       m.packed[m.MOTION_CHAIN][0])
    assert EMAVFI(dcn_max_offset=1).with_spatial(None, 8, 64).packed == {}
