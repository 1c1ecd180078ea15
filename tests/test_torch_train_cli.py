"""The port's Trainer on its own (CPU, float32, deterministic): an
interrupted run that resumes ends where an uninterrupted one ends
(params, optimizer state, scheduler, EMA, best-model watermark and the
resumed epoch's train loss, all exactly); the exported `.npz` loads into
the JAX package and into the port's FrameInterpolator, whose midpoint
matches the JAX model's on the same weights (1e-4); the train CLI runs
one tiny epoch with `--device cpu` (a snapshot and a profiler trace
written) and raises without a card otherwise;
the trainer refuses what it cannot honour."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.torch_train_case import QOCC_TINY, make_data, out_paths
from vfi_tpu_torch.train import Trainer
from vfi_tpu_torch.utils.config import MeshConfig, TrainConfig

# No VGG here (it only costs time); everything else is the recipe's.
FAST = dict(QOCC_TINY, vgg_weight=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("data")))


def _cfg(data, root, **kw):
    return TrainConfig(**dict(FAST, **data, **out_paths(str(root)), **kw))


def _state(trainer):
    opt = trainer.state.optimizer.state_dict()
    return {"params": {k: v.clone() for k, v in
                       trainer.state.params.state_dict().items()},
            "opt": {i: {f: v.clone() for f, v in st.items()}
                    for i, st in opt["state"].items()},
            "lr": [g["lr"] for g in opt["param_groups"]],
            "ema": [p.clone() for p in trainer.ema_params.parameters()],
            "sched": trainer.scheduler.state_dict(),
            "best": trainer.best_val, "step": trainer.state.step}


def _assert_same(a, b):
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for i in a["opt"]:
        for f in a["opt"][i]:
            assert torch.equal(a["opt"][i][f], b["opt"][i][f]), (i, f)
    for x, y in zip(a["ema"], b["ema"]):
        assert torch.equal(x, y)
    for k in ("lr", "sched", "best", "step"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("stop_at", [3, 5], ids=["mid_epoch", "after_train"])
def test_interrupted_run_resumes_to_the_uninterrupted_end(data, tmp_path,
                                                          stop_at):
    """Two epochs of two steps. The interrupt comes at the 3rd train step
    call (inside epoch 2) or at the 5th (none: epoch 2's val, replaced by
    an interrupt in its eval step)."""
    ref = Trainer(_cfg(data, tmp_path / "ref", num_epochs=2), device="cpu")
    ref_hist = ref.run(log=lambda *_: None)

    cfg = _cfg(data, tmp_path / "cut", num_epochs=2)
    cut = Trainer(cfg, device="cpu")
    calls = {"n": 0}
    step, evals = cut.train_step, cut.eval_step

    def train_step(*a):
        calls["n"] += 1
        if calls["n"] == stop_at:
            raise KeyboardInterrupt
        return step(*a)

    def eval_step(*a):
        if calls["n"] == 4 and stop_at == 5:
            raise KeyboardInterrupt
        return evals(*a)

    cut.train_step, cut.eval_step = train_step, eval_step
    with pytest.raises(KeyboardInterrupt):
        cut.run(log=lambda *_: None)
    resumed = Trainer(cfg, device="cpu")
    assert resumed.start_epoch == 1
    hist = resumed.run(log=lambda *_: None)
    _assert_same(_state(resumed), _state(ref))
    assert hist["train_loss"] == ref_hist["train_loss"][1:]
    assert hist["val_loss"] == ref_hist["val_loss"][1:]


def test_export_loads_into_both_packages(data, tmp_path):
    import jax
    import jax.numpy as jnp

    from vfi_tpu.models import EMAVFI as JEMAVFI
    from vfi_tpu.models.flownet import SimpleFlowNet as JFlowNet
    from vfi_tpu.models.prior import prior_prewarp as j_prior
    from vfi_tpu.utils.convert import load_params_npz as j_load
    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.utils.convert import load_params_npz

    Trainer(_cfg(data, tmp_path), device="cpu").run(log=lambda *_: None)
    best = str(tmp_path / "best")
    jm, jf = j_load(best + ".npz"), j_load(best + ".flow.npz")
    rng = np.random.default_rng(0)
    f0 = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    f1 = np.roll(f0, (1, 2), axis=(1, 2))
    eng = FrameInterpolator(load_params_npz(best + ".npz"),
                            flow_params=load_params_npz(best + ".flow.npz"),
                            flow_mid_channels=8, flow_levels=2, bf16=False,
                            dcn_max_offset=1, warp_max_flow=16,
                            cascade_levels=2, device="cpu")
    got = eng.midpoints(f0, f1)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    def jax_midpoint(a, b):
        b2, _ = j_prior(lambda x, y: JFlowNet(mid_channels=8, levels=2)
                        .apply(jf, x, y), a, b)
        return JEMAVFI(mid_channels=8, num_blocks=1, fuse_project=True,
                       dcn_max_offset=1, warp_max_flow=16,
                       cascade_levels=2).apply(jm, a, b2)

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax_midpoint)(*(jnp.asarray((f - mean) / std)
                                      for f in (f0, f1)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


def test_train_cli_one_epoch_on_cpu_and_needs_a_card(data, tmp_path,
                                                     monkeypatch, capsys):
    from vfi_tpu_torch.cli import train as tcli

    argv = ["--num-epochs", "1"]
    for k, v in dict(FAST, **data, **out_paths(str(tmp_path)), num_epochs=3,
                     snapshot_every=1,
                     profile_dir=str(tmp_path / "prof")).items():
        argv += [f"--{k}", "[32,32]" if k == "crop_size" else str(v)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    assert "done: best val loss" in capsys.readouterr().out
    assert os.path.exists(str(tmp_path / "best.npz"))
    assert os.listdir(tmp_path / "ckpt").count("torch_epoch_000000.pt") == 1
    assert os.path.exists(tmp_path / "ckpt" / "snapshots" / "epoch_1.npz")
    assert os.listdir(tmp_path / "prof") == ["trace_epoch_1.json"]


def test_trainer_refuses_what_it_cannot_honour(data, tmp_path):
    # a mesh of more ranks than this process's group (none: one rank);
    # the JAX trainer's batch divisibility over 'data'
    with pytest.raises(ValueError, match="needs 8 ranks, have 1"):
        Trainer(_cfg(data, tmp_path, mesh=MeshConfig(data=8)), device="cpu")
    with pytest.raises(ValueError, match="1 ranks not divisible by "
                                         "spatial=2"):
        Trainer(_cfg(data, tmp_path, mesh=MeshConfig(spatial=2)),
                device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        Trainer(_cfg(data, tmp_path, accum_steps=3), device="cpu")
    with pytest.raises(ValueError, match="flow_prior"):
        Trainer(_cfg(data, tmp_path, train_flow_estimator=False),
                device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        Trainer(_cfg(data, tmp_path, init_model_path=os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "artifacts", "emavfi_qocc_best.npz")), device="cpu")
    orbax = tmp_path / "orbax"
    os.makedirs(orbax / "ckpt" / "7")
    with pytest.raises(RuntimeError, match="orbax"):
        Trainer(_cfg(data, orbax), device="cpu")
    Trainer(dataclasses.replace(_cfg(data, orbax), resume=False),
            device="cpu")
