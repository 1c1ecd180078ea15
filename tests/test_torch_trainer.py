"""The port's Trainer against the JAX package's Trainer: one epoch of the
qocc recipe's flags at a tiny width (tests/torch_train_case.py) on one
directory of PNGs, both from the same warm-start `.npz` files and VGG
tree written by the JAX package, float32 (`bf16 false`), EMA on, cosine
schedule, best export gated on val PSNR. The JAX side runs on one device
(`mesh.data 1`) at HIGHEST matmul precision.

The history, every metrics.jsonl value but the wall-clock seconds, and
each leaf of the exported best `.npz`, `.flow.npz` and `ema_latest.npz`
agree to 1e-4 relative (a leaf to its largest magnitude)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_train_case import (QOCC_TINY, flat, make_data, out_paths,
                                    write_init)

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    kw = dict(QOCC_TINY, **make_data(root), **write_init(root))
    out = {}
    for side in ("jax", "port"):
        d = os.path.join(root, side)
        if side == "jax":
            from vfi_tpu.train.loop import Trainer
            from vfi_tpu.utils.config import MeshConfig, TrainConfig

            with jax.default_matmul_precision("highest"):
                trainer = Trainer(TrainConfig(mesh=MeshConfig(data=1),
                                              **kw, **out_paths(d)))
                history = trainer.run(log=lambda *_: None)
            trainer.ckpt.close()
        else:
            from vfi_tpu_torch.train import Trainer
            from vfi_tpu_torch.utils.config import TrainConfig

            trainer = Trainer(TrainConfig(**kw, **out_paths(d)),
                              device="cpu")
            history = trainer.run(log=lambda *_: None)
        out[side] = (d, history)
    return out


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=0, err_msg=what)


def test_history_and_metrics_match_jax(runs):
    (jd, jh), (pd, ph) = runs["jax"], runs["port"]
    assert sorted(ph) == sorted(jh)
    for k in jh:
        _close(ph[k], jh[k], k)
    jm, pm = ([json.loads(line) for line in
               open(os.path.join(d, "ckpt", "metrics.jsonl"))]
              for d in (jd, pd))
    assert len(jm) == len(pm) == 1 and sorted(jm[0]) == sorted(pm[0])
    for k in jm[0]:
        if k != "seconds":
            _close(pm[0][k], jm[0][k], k)
    assert pm[0]["step"] == jm[0]["step"] == 2


@pytest.mark.parametrize("name", ["best.npz", "best.flow.npz",
                                  os.path.join("ckpt", "ema_latest.npz")])
def test_exports_match_jax(runs, name):
    from vfi_tpu.utils.convert import load_params_npz

    (jd, _), (pd, _) = runs["jax"], runs["port"]
    ref, got = (flat(load_params_npz(os.path.join(d, name)))
                for d in (jd, pd))
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        err = np.abs(got[k] - ref[k]).max()
        assert err <= TOL * np.abs(ref[k]).max(), (k, err)


def test_sample_dump_written(runs):
    from vfi_tpu_torch import native

    pd, _ = runs["port"]
    path = os.path.join(pd, "imgs", "epoch_1_generated.png")
    img = native.decode_png_rgb(open(path, "rb").read())
    assert img.shape == (32, 32, 3)
