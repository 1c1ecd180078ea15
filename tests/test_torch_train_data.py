"""The port's training data and configuration against `vfi_tpu`, bit for
bit: augmentation over every branch from the same `np.random.Generator`,
the dataset's `get`, the loader's batches for two epochs on one directory
of PNGs (written with the port's encoder), and `TrainConfig` from the
YAML and from `--key value` overrides (equal dataclasses). The port's
override reader is held to `yaml.safe_load` on every override value the
repo's scripts and README pass to `train.py`."""

import dataclasses
import glob
import os
import re
import shlex
import sys

import numpy as np
import pytest
import torch
import yaml

from vfi_tpu.data import augment as jaug
from vfi_tpu.data.dataset import TripletDataset as JTripletDataset
from vfi_tpu.data.loader import DataLoader as JDataLoader
from vfi_tpu.utils import config as jcfg
from vfi_tpu_torch import native
from vfi_tpu_torch.data import (AugmentConfig, DataLoader, TripletDataset,
                                augment_triplet)
from vfi_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed, h=24, w=30):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
            for _ in range(3)]


AUGMENTS = {
    "crop": dict(crop_size=(16, 20), random_rotation=False,
                 horizontal_flip=False, color_jitter=False,
                 random_grayscale=0.0),
    "rotation": dict(crop_size=None, random_rotation=True,
                     horizontal_flip=False, color_jitter=False,
                     random_grayscale=0.0),
    "flip": dict(crop_size=None, random_rotation=False,
                 horizontal_flip=True, color_jitter=False,
                 random_grayscale=0.0),
    "grayscale": dict(crop_size=None, random_rotation=False,
                      horizontal_flip=False, color_jitter=False,
                      random_grayscale=0.9),
    "jitter": dict(crop_size=None, random_rotation=False,
                   horizontal_flip=False, random_grayscale=0.0),
    "jitter_consistent": dict(crop_size=None, random_rotation=False,
                              horizontal_flip=False, random_grayscale=0.0,
                              consistent_jitter=True),
    "everything": dict(crop_size=(20, 20)),
    "qocc": dict(crop_size=(16, 16), random_rotation=False,
                 consistent_jitter=True),
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_augment_bit_for_bit(name):
    """Eight draws a branch: crop, rotation, flip, grayscale, independent
    and consistent jitter, and all of them together."""
    kw = AUGMENTS[name]
    for seed in range(8):
        frames = _frames(seed)
        ref = jaug.augment_triplet(frames, np.random.default_rng(seed),
                                   jaug.AugmentConfig(**kw))
        got = augment_triplet(frames, np.random.default_rng(seed),
                              AugmentConfig(**kw))
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


def _write_scenes(root, scenes, frames, h, w, seed):
    rng = np.random.default_rng(seed)
    for s in range(scenes):
        d = os.path.join(root, f"scene{s}")
        os.makedirs(d)
        base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for f in range(frames):
            with open(os.path.join(d, f"frame{f:02d}.png"), "wb") as fh:
                fh.write(native.encode_png_rgb(np.roll(base, (f, 2 * f),
                                                       axis=(0, 1))))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("triplets"))
    _write_scenes(root, 3, 5, 28, 36, seed=1)
    return root


AUG = dict(crop_size=(16, 20), consistent_jitter=True)


def test_dataset_get_bit_for_bit(data_dir):
    ref = JTripletDataset(data_dir, augment=jaug.AugmentConfig(**AUG))
    got = TripletDataset(data_dir, augment=AugmentConfig(**AUG))
    assert got.triplets == ref.triplets and len(got) == 9
    for idx in range(len(got)):
        for norm in (True, False):
            ref.normalize = got.normalize = norm
            a = ref.get(idx, np.random.default_rng(idx))
            b = got.get(idx, np.random.default_rng(idx))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_dataset_cache_is_fifo_and_read_only(data_dir):
    ds = TripletDataset(data_dir)
    one = ds._load(ds.triplets[0][0]).nbytes
    ds.cache_decoded_mb = 2.5 * one / 1e6      # room for two frames
    paths = [p for trip in ds.triplets[:3] for p in trip]
    for p in paths:
        ds._load(p)
    assert ds._cache_bytes <= 2.5 * one and len(ds._cache) == 2
    assert list(ds._cache) == list(dict.fromkeys(paths))[-2:]
    img = next(iter(ds._cache.values()))
    assert not img.flags.writeable
    off = TripletDataset(data_dir, cache_decoded_mb=0)
    off._load(paths[0])
    assert not off._cache


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_batches_bit_for_bit_over_two_epochs(data_dir, shuffle,
                                                    drop_last):
    ref = JDataLoader(JTripletDataset(data_dir,
                                      augment=jaug.AugmentConfig(**AUG)),
                      2, shuffle=shuffle, seed=5, drop_last=drop_last)
    got = DataLoader(TripletDataset(data_dir, augment=AugmentConfig(**AUG)),
                     2, shuffle=shuffle, seed=5, drop_last=drop_last)
    assert len(got) == len(ref) == (4 if drop_last else 5)
    for epoch in range(2):
        rb, gb = list(ref), list(got)
        assert got.epoch == ref.epoch == epoch + 1
        assert len(rb) == len(gb) == len(ref)
        for r, g in zip(rb, gb):
            for x, y in zip(r, g):
                np.testing.assert_array_equal(x, y)


def test_loader_stops_its_producer_when_left_early(data_dir):
    loader = DataLoader(TripletDataset(data_dir), 1, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()      # the producer sees the stop and is joined
    assert loader.epoch == 1


# ---- configuration ----

def test_yaml_config_equals_jax():
    path = os.path.join(REPO, "config", "train_config.yaml")
    assert dataclasses.asdict(tcfg.load_train_config(path)) == \
        dataclasses.asdict(jcfg.load_train_config(path))
    assert dataclasses.asdict(tcfg.TrainConfig()) == \
        dataclasses.asdict(jcfg.TrainConfig())
    assert dataclasses.asdict(tcfg.InferConfig()) == \
        dataclasses.asdict(jcfg.InferConfig())


QOCC_RECIPE = shlex.split(
    "--batch_size 16 --accum_steps 8 --remat true --random_rotation false "
    "--consistent_jitter true --crop_size [320,320] --target_unit_range true "
    "--best_metric val_psnr --warp_max_flow 16 --use_pallas true "
    "--ema_decay 0.998 --flow_prior true --flow_photo_pyramid true "
    "--fuse_project true --lr_schedule cosine --learning_rate 5e-5 "
    "--cosine_min_lr 5e-6 --dcn_max_offset 1 --cascade_levels 2 "
    "--flow_photo_occlusion true --init_model_path a.npz "
    "--init_flow_path a.flow.npz --color_jitter.hue 0.05 --mesh.data 1 "
    "--plateau_min_lr 2e-5 --vgg_weights_path null --dcn_tile_w None")


@pytest.mark.parametrize("with_yaml", [True, False])
def test_overrides_equal_jax(with_yaml):
    path = (os.path.join(REPO, "config", "train_config.yaml") if with_yaml
            else None)
    got = tcfg.load_train_config(path, QOCC_RECIPE)
    ref = jcfg.load_train_config(path, QOCC_RECIPE)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.learning_rate == 5e-5 and got.crop_size == (320, 320)
    assert got.mesh.data == 1 and got.color_jitter.hue == 0.05


def _override_values():
    """Every `--key value` pair in tools/queue*.sh and README.md whose key
    is a TrainConfig field (shell quotes removed; pairs that use shell
    variables, and shell redirections, skipped)."""
    fields = {f.name for f in dataclasses.fields(jcfg.TrainConfig)} | {
        "color_jitter.hue", "color_jitter.brightness", "mesh.data",
        "mesh.spatial"}
    files = sorted(glob.glob(os.path.join(REPO, "tools", "queue*.sh")))
    files.append(os.path.join(REPO, "README.md"))
    pairs = set()
    for path in files:
        text = open(path).read().replace("\\\n", " ")
        for m in re.finditer(r"--([a-z_][a-z_.0-9]*)\s+(\"[^\"]*\"|'[^']*'|"
                             r"[^\s\\\"';)`<>|&][^\s\\\"';)`]*)", text):
            key, val = m.group(1), m.group(2)
            if key in fields and "$" not in val:
                pairs.add((key, shlex.split(val)[0] if val.strip("'\"")
                           else ""))
    return sorted(pairs)


OVERRIDES = _override_values()


def test_override_scan_finds_the_recipes():
    keys = {k for k, _ in OVERRIDES}
    assert {"crop_size", "learning_rate", "cosine_min_lr", "remat",
            "best_metric", "ema_decay"} <= keys
    assert len(OVERRIDES) > 40


@pytest.mark.parametrize("key,value", OVERRIDES,
                         ids=[f"{k}={v}" for k, v in OVERRIDES])
def test_override_reader_matches_yaml(key, value):
    """The reader gives what yaml.safe_load gives, and the override gives
    the JAX package's TrainConfig (or the same error: README prose such as
    `--dcn_tile_w are` is no value)."""
    got = tcfg.parse_scalar(value)
    ref = yaml.safe_load(value)
    assert got == ref and type(got) is type(ref)
    argv = [f"--{key}", value]
    try:
        ref_cfg = jcfg.load_train_config(None, argv)
    except (KeyError, ValueError) as e:
        with pytest.raises(type(e)):
            tcfg.load_train_config(None, argv)
        return
    assert dataclasses.asdict(tcfg.load_train_config(None, argv)) == \
        dataclasses.asdict(ref_cfg)


SCALARS = ["5e-5", "2e-5", "1.0e-5", ".5", "1_000", "0x1f", "010", "+3",
           "-1", "1:30", "-.inf", ".nan", "true", "True", "yes", "off",
           "null", "~", "None", "none", "'a b'", '"q\\"x"', "[320,320]",
           "[ 1, 'a', [2, 3] ]", "[]", "v4", "runs/q/ckpt", "x # c", ""]


@pytest.mark.parametrize("text", SCALARS)
def test_parse_scalar_matches_yaml(text):
    got, ref = tcfg.parse_scalar(text), yaml.safe_load(text)
    if isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(got)
    else:
        assert got == ref and type(got) is type(ref)


def test_unknown_keys_and_unread_values_fail():
    with pytest.raises(KeyError, match="Unknown config key"):
        tcfg.load_train_config(None, ["--no_such_key", "1"])
    with pytest.raises(KeyError, match="Unknown config key"):
        tcfg.load_train_config(None, ["--mesh.axis", "1"])
    with pytest.raises(ValueError, match="only scalars"):
        tcfg.parse_scalar("{a: 1}")
    with pytest.raises(ValueError):
        tcfg.load_train_config(None, ["--batch_size"])


def test_yaml_file_needs_pyyaml(monkeypatch):
    """Without pyyaml a YAML file raises ImportError naming it; overrides
    alone still load."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        tcfg.load_train_config(os.path.join(REPO, "config",
                                            "train_config.yaml"))
    assert tcfg.load_train_config(None, ["--crop_size", "[320,320]"]) \
        .crop_size == (320, 320)
