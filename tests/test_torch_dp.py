"""Data parallelism of the port against the JAX package, float32 on the
CPU: the engine over a mesh of two (and three) CPU replicas against the
JAX one-device engine, with an odd batch and a `max_px_per_launch` split
(tolerance 1e-5 on [0, 1] midpoints); one train step over 2 gloo ranks
with accumulation 2 against JAX's one-device `make_train_step`, at
`tests/test_parallel.py`'s tolerances (loss rtol 1e-5, params rtol 2e-4 /
atol 2e-5); the qocc recipe's step (joint flow, prior, occlusion-masked
photometric pyramid, remat) over 2 ranks against the port's one-process
step (terms rtol 1e-5, gradients within 1e-5 of their norm); the train
CLI's two-rank gloo run against its one-process run; the trainer's mesh
refusals against the JAX trainer's."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_case import run_ranks, train_state, train_tree
from tests.torch_train_case import QOCC_TINY, make_data, out_paths
from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.losses import LossWeights as JLossWeights
from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.models.flownet import SimpleFlowNet as JFlowNet
from vfi_tpu.parallel import make_mesh as j_make_mesh
from vfi_tpu.train import state as jstate
from vfi_tpu.train.loop import Trainer as JTrainer
from vfi_tpu.train.loop import make_train_step as j_make_train_step
from vfi_tpu.utils.config import MeshConfig as JMeshConfig
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.cli import train as tcli
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.losses import LossWeights
from vfi_tpu_torch.parallel import make_mesh
from vfi_tpu_torch.train import Trainer, make_train_step
from vfi_tpu_torch.train import loop as tloop
from vfi_tpu_torch.train.loop import data_rows
from vfi_tpu_torch.utils.config import MeshConfig, TrainConfig
from vfi_tpu_torch.utils.convert import (load_params_npz, params_from_jax,
                                         params_to_jax)

CPU = torch.device("cpu")
BOUNDED = dict(dcn_max_offset=1, warp_max_flow=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---- the engine ----

@pytest.fixture(scope="module")
def engine_case():
    model = JEMAVFI(mid_channels=16, num_blocks=2, **BOUNDED)
    x = jnp.zeros((1, 32, 48, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), x, x)
    params = jax.tree.map(np.asarray, params)
    oc = params["params"]["fusion_dcn0"]["offset_conv"]
    oc["bias"] = np.random.default_rng(1).uniform(
        -1.5, 1.5, oc["bias"].shape).astype(np.float32)
    rng = np.random.default_rng(5)
    f0 = rng.uniform(0, 1, (3, 32, 48, 3)).astype(np.float32)
    f1 = np.roll(f0, (1, -2), axis=(1, 2))
    with jax.default_matmul_precision("highest"):
        ref = JFI(params, bf16=False, mesh=j_make_mesh(
            data=1, devices=jax.devices()[:1]), **BOUNDED).midpoints(f0, f1)
    return params, (f0, f1), np.asarray(ref)


@pytest.mark.parametrize("data", [2, 3])
@pytest.mark.parametrize("max_px", [None, 2 * 32 * 48])
def test_dp_engine_matches_jax_engine(engine_case, data, max_px):
    """An odd batch of 3 (padded with its last pair to a multiple of the
    'data' axis and sliced back), whole or split by the pixel guard into
    launches the axis divides."""
    params, (f0, f1), ref = engine_case
    eng = FrameInterpolator(params, bf16=False, conv_kernel="pallas",
                            mesh=make_mesh(data, devices=[CPU] * data),
                            max_px_per_launch=max_px, **BOUNDED)
    assert len(eng._replicas) == 1        # one device: one replica
    out = eng.midpoints(f0, f1)
    assert out.shape == f0.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    seq = eng.midpoints_sequence(np.concatenate([f0[:1], f1[:1]]))
    np.testing.assert_allclose(seq.numpy(), ref[:1], rtol=1e-5, atol=1e-5)


def test_dp_engine_checks_its_devices(engine_case):
    params = engine_case[0]
    with pytest.raises(ValueError, match="first device"):
        FrameInterpolator(params, bf16=False, device="cpu",
                          mesh=make_mesh(1, devices=[torch.device("meta")]),
                          **BOUNDED)
    eng = FrameInterpolator(params, bf16=False, device="cpu", **BOUNDED)
    assert eng.mesh.shape == {"data": 1, "spatial": 1}
    assert eng._guard_cap(np.zeros((1, 32, 48, 3))) == 8_000_000 // 1536


# ---- the train step ----

def test_dp_train_step_matches_jax_single_device():
    """`tests/test_parallel.py`'s DP case (EMAVFI mid 8, one block, the JAX
    defaults; no VGG, no temporal term; batch 8 of 16x16; AdamW at 1e-3),
    with accumulation 2: 2 gloo ranks against JAX's one-device step."""
    model = JEMAVFI(mid_channels=8, num_blocks=1)
    x0 = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x0, x0)
    rng = np.random.default_rng(0)
    batch = [rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
             for _ in range(3)]
    weights = dict(vgg=0.0, temporal=0.0)
    with jax.default_matmul_precision("highest"):
        step = jax.jit(j_make_train_step(model, None, 0,
                                         JLossWeights(**weights),
                                         accum_steps=2))
        st, met = step(jstate.create_train_state(params, 1e-3), None,
                       *map(jnp.asarray, batch))
    res = run_ranks("dp_train_case", 2, {
        "model_kw": dict(mid_channels=8, num_blocks=1),
        "state": params_from_jax(jax.tree.map(np.asarray, params)),
        "lr": 1e-3, "accum": 2, "weights": weights, "batch": batch})
    np.testing.assert_allclose(res[0]["metrics"]["loss"], float(met["loss"]),
                               rtol=1e-5)
    ref = _flat(jax.tree.map(np.asarray, st.params))
    for r in res:
        got = _flat(params_to_jax(r["params"]))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
    for k, v in res[0]["params"].items():        # every rank the same
        assert torch.equal(v, res[1]["params"][k]), k


def test_dp_train_step_of_the_qocc_recipe_matches_one_process():
    """The tiny qocc recipe (joint flow, prior, occlusion-masked
    photometric pyramid, remat; no VGG) at batch 4, accumulation 2: each
    rank one row a microbatch. The occlusion-masked term is a ratio of
    sums over the microbatch, which the ranks complete together."""
    x = jnp.zeros((1, 32, 32, 3))
    model_kw = dict(mid_channels=8, num_blocks=1, dcn_max_offset=1,
                    warp_max_flow=16, cascade_levels=2, fuse_project=True)
    rng = np.random.default_rng(2)

    def drawn(s):
        std = (1.0 / np.prod(s.shape[:-1])) ** 0.5 if len(s.shape) > 1 \
            else 0.05
        return rng.normal(0, std, s.shape).astype(np.float32)

    mp_, fp = (jax.tree.map(drawn, jax.eval_shape(
        m.init, jax.random.PRNGKey(0), x, x))
        for m in (JEMAVFI(**model_kw), JFlowNet(mid_channels=8, levels=2)))
    f0 = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    f1 = np.roll(f0, (1, 2), axis=(1, 2)) * 0.9 + 0.05
    batch = [f0, (f0 + f1) / 2, f1]
    flags = dict(remat=True, target_unit_range=True, flow_prior=True,
                 flow_photo_pyramid=True, flow_photo_occlusion=True,
                 joint_flow=True)
    weights = dict(charbonnier=0.5, vgg=0.0, color=0.3, gradient=0.1,
                   temporal=0.15)
    spec = {"model_kw": model_kw, "state": params_from_jax(mp_),
            "flow_kw": dict(mid_channels=8, levels=2),
            "flow_state": params_from_jax(fp), "lr": None, "accum": 2,
            "weights": weights, "batch": batch, "flags": flags}
    tree = train_tree(spec)
    met = make_train_step(None, 0, LossWeights(**weights), accum_steps=2,
                          **flags)(train_state(tree, spec),
                                   *map(torch.from_numpy, batch))
    res = run_ranks("dp_train_case", 2, spec)
    got = res[0]["metrics"]
    assert sorted(got) == sorted(met)
    for k in met:
        np.testing.assert_allclose(got[k], float(met[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    for k, p in tree.named_parameters():
        err = (res[0]["grads"][k] - p.grad).norm().item()
        assert err <= 1e-5 * p.grad.norm().item() + 1e-9, (k, err)
        assert torch.equal(res[0]["grads"][k], res[1]["grads"][k]), k


def test_data_rows_split_each_microbatch():
    assert data_rows(8, 2, 0, 2).tolist() == [0, 1, 4, 5]
    assert data_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert data_rows(16, 8, 1, 2).tolist() == list(range(1, 16, 2))
    assert sorted(np.concatenate([data_rows(12, 3, i, 2)
                                  for i in range(2)]).tolist()) == \
        list(range(12))


# ---- the trainer and its CLI ----

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("data")))


def _cfg(data, root, **kw):
    return TrainConfig(**dict(QOCC_TINY, vgg_weight=0.0, **data,
                              **out_paths(str(root)), **kw))


@pytest.mark.parametrize("batch,accum,mesh", [(3, 1, (2, 1)), (4, 4, (2, 1)),
                                              (6, 3, (4, 1))])
def test_trainer_mesh_refusals_match_jax(data, tmp_path, monkeypatch, batch,
                                         accum, mesh):
    """A batch the 'data' axis does not divide, and microbatches it does
    not: the JAX trainer's messages, on a group of the mesh's ranks."""
    jcfg = JTrainConfig(batch_size=batch, accum_steps=accum,
                        mesh=JMeshConfig(*mesh), train_data_dir="none",
                        val_data_dir="none")
    with pytest.raises(ValueError) as ref:
        JTrainer(jcfg)
    monkeypatch.setattr(tloop.comm, "size", lambda g=None: mesh[0])
    monkeypatch.setattr(tloop.comm, "rank", lambda g=None: 0)
    with pytest.raises(ValueError) as got:
        Trainer(_cfg(data, tmp_path, batch_size=batch, accum_steps=accum,
                     mesh=MeshConfig(*mesh)), device="cpu",
                data_group=object())
    assert str(got.value) == str(ref.value)


def test_trainer_takes_every_rank(data, tmp_path, monkeypatch):
    """A mesh must take exactly the group's ranks: none dropped."""
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        Trainer(_cfg(data, tmp_path, batch_size=4, mesh=MeshConfig(2)),
                device="cpu")
    monkeypatch.setattr(tloop.comm, "size", lambda g=None: 3)
    with pytest.raises(ValueError, match="3 ranks not divisible by "
                                         "spatial=2"):
        Trainer(_cfg(data, tmp_path, mesh=MeshConfig(-1, 2)), device="cpu",
                data_group=object())
    assert tloop.mesh_axes(-1, 2, 4) == (2, 2)


def test_train_cli_data_parallel_matches_one_process(data, tmp_path):
    """`--mesh.data 2 --device cpu` starts two gloo ranks: one epoch of the
    tiny recipe at batch 4 ends where the one-process run ends (val
    metrics, the exported EMA weights), and rank 0 alone writes."""
    runs = {}
    for name, extra in (("one", []), ("dp", ["--mesh.data", "2"])):
        root = tmp_path / name
        argv = ["--device", "cpu", "--batch_size", "4"] + extra
        for k, v in {**data, **out_paths(str(root))}.items():
            argv += [f"--{k}", v]
        for k, v in dict(QOCC_TINY, vgg_weight=0.0, batch_size=4).items():
            if k not in ("batch_size",):
                argv += [f"--{k}", "[32,32]" if k == "crop_size" else str(v)]
        assert tcli.main(argv) == 0
        with open(root / "ckpt" / "metrics.jsonl") as f:
            lines = [json.loads(ln) for ln in f]
        runs[name] = (lines, load_params_npz(str(root / "best.npz")))
        assert os.listdir(root / "imgs") == ["epoch_1_generated.png"]
    (l1, p1), (l2, p2) = runs["one"], runs["dp"]
    assert len(l1) == len(l2) == 1
    for k in ("train_loss", "val_loss", "val_psnr", "val_ssim"):
        np.testing.assert_allclose(l2[0][k], l1[0][k], rtol=1e-5, err_msg=k)
    a, b = _flat(p1), _flat(p2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)


def test_train_cli_refuses_more_ranks_than_cards(data, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = dataclasses.replace(_cfg(data, tmp_path, batch_size=4),
                              mesh=MeshConfig(2))
    with pytest.raises(ValueError, match="needs 2 cards, 1 visible"):
        tcli.ranks_for(cfg, "cuda")
    assert tcli.ranks_for(cfg, "cpu") == 2
    assert tcli.ranks_for(dataclasses.replace(cfg, mesh=MeshConfig()),
                          "cuda") == 1
    assert tcli.ranks_for(dataclasses.replace(cfg, mesh=MeshConfig()),
                          "cuda:0") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="takes cards 0..n-1"):
        tcli.ranks_for(cfg, "cuda:1")
