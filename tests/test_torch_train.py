"""The port's optimizer, schedules, weight export, checkpoints and train
step against `vfi_tpu` (float32, CPU).

- The optimizer (global-norm clip at 0.1, then AdamW) against optax on one
  tree and the same gradients, after one step and after ten: 1e-6
  relative to each leaf's largest value (Adam's update is elementwise).
- The schedules' learning rates over 50 epochs: equal.
- `params_to_jax(params_from_jax(tree))` equals the tracked checkpoints
  leaf for leaf.
- One train step at the qocc recipe's flags, at a tiny shape (mid 8, one
  block, crops 32x32, batch 2, accum 2, remat), against `jax.grad` of the
  JAX step: each leaf's gradient within 1e-4 of the JAX leaf's norm, the
  loss terms within 1e-5 relative. The same random params on both sides
  (the DCN's offset conv too: with JAX's zero init every offset lies on
  an integer, where the JAX shifts op and the port take different
  subgradients, see ROADMAP §3) and one VGG tree from JAX's init.
- The accumulated step against the monolithic one (as
  tests/test_train.py holds the JAX step): the same update to 5e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from vfi_tpu.losses import LossWeights as JLossWeights
from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.models.flownet import SimpleFlowNet as JFlowNet
from vfi_tpu.models.vgg import VGG16Features as JVGG
from vfi_tpu.ops.deform_conv import deform_conv2d as j_exact_dcn
from vfi_tpu.train import state as jstate
from vfi_tpu.train.loop import make_train_step as j_make_train_step
from vfi_tpu_torch.losses import LossWeights
from vfi_tpu_torch.models import EMAVFI, SimpleFlowNet
from vfi_tpu_torch.models.vgg import VGG16Features
from vfi_tpu_torch.ops.cuda import deform_conv2d_bounded_plain
from vfi_tpu_torch.train import (CheckpointManager, CosineScheduler,
                                 PlateauScheduler, TrainState,
                                 create_train_state, get_learning_rate,
                                 make_train_step, set_learning_rate)
from vfi_tpu_torch.train.checkpoints import (jax_tree, load_params_into,
                                             save_params_npz)
from vfi_tpu_torch.utils.convert import (load_params_npz, params_from_jax,
                                         params_to_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts")
GRAD_TOL = 1e-4
TERM_TOL = 1e-5


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
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


# ---- optimizer and schedules ----

SHAPES = {"a": (3, 3, 4, 8), "b": (8,), "c": (5, 7)}


class _Leaves(nn.Module):
    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_optimizer_matches_optax(scale):
    """clip_by_global_norm(0.1) -> AdamW(5e-4, wd 1e-5) over ten steps of
    seeded gradients (below and above the clip norm), with a learning-rate
    change after step 5, against the JAX package's optimizer."""
    rng = np.random.default_rng(0)
    tree = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, tree), 5e-4)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    mod = _Leaves(tree)
    st = create_train_state(mod, 5e-4)
    for step in range(10):
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                 for k, s in SHAPES.items()}
        jst = apply(jst, jax.tree.map(jnp.asarray, grads))
        for k, p in mod.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        norm = st.apply_gradients()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            jax.tree.map(jnp.asarray, grads))), rtol=1e-6)
        if step == 4:
            jst = jstate.set_learning_rate(jst, 1e-4)
            set_learning_rate(st, 1e-4)
        if step in (0, 9):
            for k, p in mod.named_parameters():
                ref = np.asarray(jst.params[k])
                np.testing.assert_allclose(
                    p.detach().numpy(), ref, rtol=0,
                    atol=1e-6 * np.abs(ref).max(), err_msg=f"{k} step {step}")
    assert st.step == int(jst.step) == 10
    assert get_learning_rate(st) == pytest.approx(
        jstate.get_learning_rate(jst))


def test_set_learning_rate_writes_every_group():
    a, b = nn.Parameter(torch.zeros(2)), nn.Parameter(torch.zeros(3))
    opt = torch.optim.AdamW([{"params": [a]}, {"params": [b]}], lr=1.0)
    st = TrainState(nn.ParameterList([a, b]), opt)
    set_learning_rate(st, 0.25)
    assert [g["lr"] for g in opt.param_groups] == [0.25, 0.25]


SCHEDULES = {
    "plateau": lambda m: m.PlateauScheduler(lr=1e-3, patience=2,
                                            min_lr=1e-4),
    "cosine": lambda m: m.CosineScheduler(lr0=5e-5, total=30,
                                          min_lr=5e-6),
    "cosine_restarts": lambda m: m.CosineScheduler(lr0=1e-3, total=50,
                                                   period=12, min_lr=1e-5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax_over_50_epochs(name):
    """The lr after each of 50 epochs (noisy val losses, a restart from the
    state dict at epoch 20) equals the JAX scheduler's."""
    import vfi_tpu_torch.train.state as tstate

    losses = 1.0 + np.random.default_rng(1).normal(0, 0.05, 50).cumsum() \
        * 0.1
    ref, got = SCHEDULES[name](jstate), SCHEDULES[name](tstate)
    for e, v in enumerate(losses):
        if e == 20:
            fresh = SCHEDULES[name](tstate)
            fresh.load_state_dict(got.state_dict())
            got = fresh
        assert got.step(float(v)) == ref.step(float(v)), e
        assert got.state_dict() == ref.state_dict()
    assert got.lr >= got.min_lr


# ---- weights back to JAX ----

@pytest.mark.parametrize("name", ["emavfi_qocc_best.npz",
                                  "emavfi_qocc_best.flow.npz",
                                  "emavfi_q12_best.npz",
                                  "emavfi_q12_best.flow.npz"])
def test_params_to_jax_round_trip(name):
    tree = load_params_npz(os.path.join(ART, name))
    back = params_to_jax(params_from_jax(tree))
    a, b = _flat(tree), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_to_jax_of_vgg_and_modules():
    vgg = VGG16Features(max_stage=1)
    vgg.init_flax_default(torch.Generator().manual_seed(0))
    tree = params_to_jax(vgg.state_dict())
    assert sorted(tree["params"]) == ["conv0", "conv1", "conv2", "conv3"]
    assert tree["params"]["conv1"]["kernel"].shape == (3, 3, 64, 64)
    joint = nn.ModuleDict({"model": EMAVFI(mid_channels=8, num_blocks=1),
                           "flow": SimpleFlowNet(mid_channels=8, levels=2)})
    jt = jax_tree(joint)
    assert set(jt) == {"model", "flow"} and "params" in jt["model"]
    other = nn.ModuleDict({"model": EMAVFI(mid_channels=8, num_blocks=1),
                           "flow": SimpleFlowNet(mid_channels=8, levels=2)})
    load_params_into(other, jt)
    for a, b in zip(joint.parameters(), other.parameters()):
        assert torch.equal(a, b)


# ---- checkpoints ----

def _tiny_state(seed):
    torch.manual_seed(seed)
    mod = _Leaves({k: np.random.default_rng(seed).normal(size=s).astype(
        np.float32) for k, s in SHAPES.items()})
    st = create_train_state(mod, 1e-3)
    for p in mod.parameters():
        p.grad = torch.ones_like(p)
    st.apply_gradients()
    return st


def test_checkpoint_save_restore_keep(tmp_path):
    st = _tiny_state(0)
    sched = CosineScheduler(lr0=1e-3, total=10)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_epoch() is None
    for e in range(4):
        sched.step(0.0)
        mgr.save(e, st, sched, extra={"val_loss": 0.5 + e, "best_val": -3.0})
    assert mgr.epochs() == [2, 3] and mgr.latest_epoch() == 3
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    payload = torch.load(os.path.join(tmp_path, "torch_epoch_000003.pt"),
                         weights_only=True)
    assert payload["meta"]["epoch"] == 3 and payload["step"] == 1

    other, sched2 = _tiny_state(1), CosineScheduler(lr0=1e-3, total=10)
    other, epoch = mgr.restore(other, sched2)
    assert epoch == 3 and other.step == 1
    assert mgr.last_meta == {"val_loss": 3.5, "best_val": -3.0,
                             "batches_done": -1, "train_running": 0.0}
    assert sched2.state_dict() == sched.state_dict()
    assert get_learning_rate(other) == sched.lr
    for a, b in zip(st.params.parameters(), other.params.parameters()):
        assert torch.equal(a, b)
    sa, sb = st.optimizer.state_dict(), other.optimizer.state_dict()
    for k in sa["state"]:
        for f in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][f], sb["state"][k][f])
    mgr.wait()
    mgr.close()


def test_checkpoint_names_leave_orbax_steps_alone(tmp_path):
    for step in (4, 5):
        os.makedirs(tmp_path / str(step))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.orbax_steps() == [4, 5] and mgr.latest_epoch() is None
    mgr.save(4, _tiny_state(0), PlateauScheduler(lr=1e-3))
    assert mgr.latest_epoch() == 4 and os.path.isdir(tmp_path / "4")


def test_save_params_npz_writes_the_jax_layout(tmp_path):
    from vfi_tpu.utils.convert import load_params_npz as j_load

    tree = load_params_npz(os.path.join(ART, "emavfi_qocc_best.flow.npz"))
    net = SimpleFlowNet()
    net.load_state_dict(params_from_jax(tree))
    out = str(tmp_path / "f.npz")
    save_params_npz(net, out)
    a, b = _flat(tree), _flat(j_load(out))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---- the train step against jax.grad ----

QOCC_FLAGS = dict(remat=True, target_unit_range=True, flow_prior=True,
                  flow_photo_pyramid=True, flow_photo_occlusion=True)
MODEL = dict(dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
             fuse_project=True)
WEIGHTS = dict(charbonnier=0.5, vgg=0.15, color=0.3, gradient=0.1,
               temporal=0.15)


# The configurations the step is held at beyond the qocc recipe: the JAX
# defaults (exact DCN, unbounded warp, 67 channels, joint flow); no flow
# module; the soft histogram with R=2, warp 16, 67 channels, cascade 2, the
# flow prior and accumulation 2; R=1 with fuse_project, no prior, the
# photometric pyramid with occlusion, and remat. Each: (model kwargs, step
# flags, joint flow, accumulation).
CONFIGS = {
    "qocc": (MODEL, QOCC_FLAGS, True, 2),
    "jax_defaults": ({}, {}, True, 1),
    "no_flow": ({}, {}, False, 1),
    "soft_hist_r2": (dict(dcn_max_offset=2, warp_max_flow=16,
                          cascade_levels=2),
                     dict(soft_histogram=True, flow_prior=True), True, 2),
    "r1_pyramid": (dict(dcn_max_offset=1, fuse_project=True),
                   dict(flow_photo_pyramid=True, flow_photo_occlusion=True,
                        remat=True), True, 1),
}
_CASES = {}


def _case(model_kw):
    """Random params of a tiny model of `model_kw` (mid 8, one block, its
    offset conv small and random) and flow net (8 wide, 2 levels) in the
    JAX trees' layout, a VGG relu2_2 tree from JAX's init, and one batch
    of two 32x32 ImageNet-normalized triplets."""
    key = tuple(sorted(model_kw.items()))
    if key in _CASES:
        return _CASES[key]
    x = jnp.zeros((1, 32, 32, 3))
    rng = np.random.default_rng(0)

    def drawn(shape):
        """A kernel at the fan-in scale of torch's init, a bias at 0.05."""
        fan_in = np.prod(shape.shape[:-1])
        std = (1.0 / fan_in) ** 0.5 if len(shape.shape) > 1 else 0.05
        return rng.normal(0, std, shape.shape).astype(np.float32)

    mp, fp = (jax.tree.map(drawn, jax.eval_shape(m.init, jax.random.PRNGKey(0),
                                                 x, x))
              for m in (JEMAVFI(mid_channels=8, num_blocks=1, **model_kw),
                        JFlowNet(mid_channels=8, levels=2)))
    vp = jax.tree.map(np.array, jax.jit(JVGG(max_stage=1).init)(
        jax.random.PRNGKey(7), x))
    oc = mp["params"]["fusion_dcn0"]["offset_conv"]
    for k in oc:
        oc[k] = rng.normal(0, 0.05, oc[k].shape).astype(np.float32)
    f0 = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    f1 = np.roll(f0, (1, 2), axis=(1, 2)) * 0.9 + 0.05
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    batch = [(a - mean) / std for a in (f0, (f0 + f1) / 2, f1)]
    _CASES[key] = (mp, fp, vp, batch)
    return _CASES[key]


@pytest.fixture(scope="module")
def qocc_case():
    return _case(MODEL)


def _port_tree(mp, fp, model_kw=MODEL, joint=True):
    m = EMAVFI(mid_channels=8, num_blocks=1, **model_kw)
    m.load_state_dict(params_from_jax(mp))
    if not joint:
        return m
    f = SimpleFlowNet(mid_channels=8, levels=2)
    f.load_state_dict(params_from_jax(fp))
    return nn.ModuleDict({"model": m, "flow": f})


def _port_vgg(vp):
    v = VGG16Features(max_stage=1)
    v.load_params(vp)
    return v.requires_grad_(False)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_step_gradients_match_jax_grad(config):
    model_kw, flags, joint, accum = CONFIGS[config]
    mp, fp, vp, batch = _case(model_kw)
    # An optax transformation that returns zero updates and keeps the
    # gradients as its state: the JAX step's state then holds its grads.
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
    params = {"model": mp, "flow": fp} if joint else mp
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=keep.init(params), tx=keep)
    with jax.default_matmul_precision("highest"):
        step = jax.jit(j_make_train_step(
            JEMAVFI(mid_channels=8, num_blocks=1, use_pallas=True,
                    **model_kw),
            JVGG(max_stage=1), 1, JLossWeights(**WEIGHTS),
            flow_module=JFlowNet(mid_channels=8, levels=2) if joint
            else None, accum_steps=accum, **flags))
        jst, jmet = step(jst, vp, *map(jnp.asarray, batch))

    tree = _port_tree(mp, fp, model_kw, joint)
    st = TrainState(tree, torch.optim.SGD(tree.parameters(), lr=0.0),
                    grad_clip_norm=float("inf"))
    met = make_train_step(_port_vgg(vp), 1, LossWeights(**WEIGHTS),
                          joint_flow=joint, accum_steps=accum, **flags)(
        st, *map(torch.from_numpy, batch))
    assert sorted(met) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=TERM_TOL, atol=1e-9, err_msg=k)
    parts = ("model", "flow") if joint else (None,)
    for part in parts:
        mod = tree[part] if part else tree
        got = _flat(params_to_jax({k: p.grad for k, p in
                                   mod.named_parameters()}))
        ref = _flat(jst.opt_state[part] if part else jst.opt_state)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == np.float32
            err = np.linalg.norm(got[k] - ref[k])
            assert err <= GRAD_TOL * np.linalg.norm(ref[k]), (part, k, err)


def test_accumulated_step_matches_monolithic(qocc_case):
    """Without the occlusion mask: its masked mean is a ratio of sums over
    the batch, so microbatches change that term's value (in the JAX step
    as here)."""
    mp, fp, vp, batch = qocc_case
    flags = dict(QOCC_FLAGS, flow_photo_occlusion=False)
    outs = {}
    for accum in (1, 2):
        tree = _port_tree(mp, fp)
        st = create_train_state(tree, 1e-3)
        met = make_train_step(_port_vgg(vp), 1, LossWeights(**WEIGHTS),
                              joint_flow=True, accum_steps=accum,
                              **flags)(st, *map(torch.from_numpy, batch))
        outs[accum] = (tree, met)
    (t1, m1), (t2, m2) = outs[1], outs[2]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-5)
    for k in m1:
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=5e-4,
                                   err_msg=k)
    for a, b in zip(t1.parameters(), t2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-6)


def test_a_step_moves_the_kernel_route_as_the_plain_one(qocc_case):
    """The trained model is never packed: a step changes its forward on
    the kernel route (the wrappers; their plain versions on the CPU) as it
    changes the plain route's, and no packed copy of the weights is left
    to go stale."""
    mp, fp, vp, batch = qocc_case
    f0, _, f1 = map(torch.from_numpy, batch)
    tree = _port_tree(mp, fp)
    model = tree["model"]
    plain = EMAVFI(mid_channels=8, num_blocks=1, use_kernels=False, **MODEL)
    with torch.no_grad():
        before = model(f0, f1)
    st = create_train_state(tree, 1e-2)
    make_train_step(None, 1, LossWeights(**WEIGHTS), joint_flow=True,
                    **QOCC_FLAGS)(st, *map(torch.from_numpy, batch))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        after, ref = model(f0, f1), plain(f0, f1)
    assert model.packed == {} and model.fusion_dcn0.packed == (None, None)
    assert (after - before).abs().max() > 1e-4
    torch.testing.assert_close(after, ref, rtol=0, atol=0)


def test_dcn_offset_gradient_at_integer_offsets_is_the_exact_ops():
    """At offsets exactly on integers (a zero-initialized offset conv) the
    port's bounded DCN takes the exact op's one-sided subgradient, as the
    JAX package's exact `deform_conv2d` does; the JAX shifts op's
    tie-split `clip(1 - |d|)` takes another (ROADMAP §3)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 6, 7, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    m = rng.uniform(size=(1, 6, 7, 9)).astype(np.float32)
    cot = rng.normal(size=(1, 6, 7, 5)).astype(np.float32)
    off = np.zeros((1, 6, 7, 18), np.float32)
    off[..., ::3] = 1.0
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.grad(lambda o: jnp.sum(j_exact_dcn(
            jnp.asarray(x), o, jnp.asarray(m), jnp.asarray(w)) * cot)))(
                jnp.asarray(off))
    o = torch.from_numpy(off).requires_grad_()
    out = deform_conv2d_bounded_plain(
        torch.from_numpy(x), o, torch.from_numpy(m),
        torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(), None, 2)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(ref), atol=1e-5)
