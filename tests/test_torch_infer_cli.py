"""The port's infer CLI (`python -m vfi_tpu_torch.cli.infer`) and its
checkpoint I/O on the CPU, held against the JAX package's own code:

- `two-frame` against the JAX CLI's PNG on the same PNG pair and weights
  (the tiny model, float32 on both sides): within 1 level of 255 (the
  float32 engines agree to ~1e-7, which truncation to uint8 can turn into
  a level); with `--size`, the port's PNG equals its engine's midpoint of
  `resize_u8`'s frames truncated to uint8, bit for bit; a JPEG input and
  a non-PNG output raise;
- `video` and `videos` on tiny MJPG files with `--device cpu`: the frame
  counts and stats the JAX CLI writes;
- the parser errors (`--auto_scale` without `--flow_prior`, and with
  `videos`) and `--spatial 2` raising;
- checkpoint I/O: `convert_ema_vfi_state_dict` of a random-init
  `EMA_VFI_Torch` (`tools/torch_reference.py`) and the VGG converter equal,
  array for array, to `vfi_tpu.utils.convert`'s; a `.pth` through
  `load_model_params` gives an engine within PTH_TOL of the JAX engine on
  the same file; `save_params_npz` read back by the JAX loader as equal
  arrays; `python -m vfi_tpu_torch.utils.convert` writes a loadable file;
- `ops.resize.resize_u8` within 1 level of Pillow's BILINEAR on
  RubberWhale, shrinking and enlarging.
"""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vfi_tpu.cli.common as jax_common
from vfi_tpu.cli.infer import main as jax_infer_main
from vfi_tpu.infer.pair import FrameInterpolator as JFI
from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu.parallel import make_mesh
from vfi_tpu.utils import convert as jconvert
from vfi_tpu_torch import native
from vfi_tpu_torch.cli import infer as tinfer
from vfi_tpu_torch.cli.common import load_model_params
from vfi_tpu_torch.infer import FrameInterpolator
from vfi_tpu_torch.ops.resize import resize_u8
from vfi_tpu_torch.utils import convert

from tools.torch_reference import EMA_VFI_Torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUBBERWHALE = os.path.join(REPO, "data", "processed", "train", "RubberWhale")
LEVELS = 1
PTH_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int16)
                      - np.asarray(b).astype(np.int16)).max())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny model's JAX `EMAVFI.init` weights as an .npz, a 32x48 PNG
    pair (a smooth texture and a shifted copy), the same pair as JPEGs,
    and two MJPG clips (30 and 15 fps)."""
    d = tmp_path_factory.mktemp("infer_cli")
    model = JEMAVFI(mid_channels=8, num_blocks=1)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    params = jax.tree.map(np.asarray,
                          jax.jit(model.init)(jax.random.PRNGKey(0), x, x))
    out = {"dir": d, "params": params, "ckpt": str(d / "tiny.npz")}
    convert.save_params_npz(params, out["ckpt"])
    rng = np.random.default_rng(9)
    base = cv2.resize(rng.uniform(0, 255, (8, 12, 3)).astype(np.float32),
                      (48, 32), interpolation=cv2.INTER_CUBIC)
    frames = [np.clip(np.roll(base, s, axis=1), 0, 255).astype(np.uint8)
              for s in (0, 3)]
    for i, fr in enumerate(frames):
        out[f"png{i}"] = str(d / f"f{i}.png")
        with open(out[f"png{i}"], "wb") as f:
            f.write(native.encode_png_rgb(fr))
        out[f"jpg{i}"] = str(d / f"f{i}.jpg")
        Image.fromarray(fr).save(out[f"jpg{i}"])
    out["frames"] = frames
    for name, fps, n in (("clip30", 30.0, 4), ("clip15", 15.0, 3)):
        path = str(d / f"{name}.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                                 (48, 32))
        for i in range(n):
            writer.write(np.roll(frames[0], 2 * i, axis=1))
        writer.release()
        out[name] = path
    return out


def _two_frame_args(files, output, extra=()):
    return ["two-frame", "--frame0", files["png0"], "--frame1",
            files["png1"], "--output", output, "--model_path", files["ckpt"],
            "--fp32", *extra]


def _read_png(path):
    with open(path, "rb") as f:
        return native.decode_png_rgb(f.read())


# -- two-frame ---------------------------------------------------------------

def test_two_frame_matches_the_jax_cli(files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # the JAX CLI's compilation cache
    jout, pout = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    with jax.default_matmul_precision("highest"):
        assert jax_infer_main(_two_frame_args(files, jout)) == 0
    assert tinfer.main(_two_frame_args(files, pout, ["--device", "cpu"])) == 0
    got, ref = _read_png(pout), np.asarray(Image.open(jout).convert("RGB"))
    assert got.shape == ref.shape == (32, 48, 3)
    assert _levels(got, ref) <= LEVELS


def test_two_frame_writes_the_engines_truncated_midpoint(files, tmp_path):
    """--size 24 40 (shrinking both ways): the PNG is the engine's midpoint
    of the resize_u8 frames, truncated to uint8, bit for bit."""
    out = str(tmp_path / "sized.png")
    assert tinfer.main(_two_frame_args(
        files, out, ["--device", "cpu", "--size", "24", "40"])) == 0
    eng = FrameInterpolator(files["params"], device="cpu", bf16=False)
    f0, f1 = (resize_u8(fr, 24, 40).astype(np.float32)[None] / 255.0
              for fr in files["frames"])
    mid = eng.midpoints(f0, f1)[0].numpy()
    np.testing.assert_array_equal(
        _read_png(out), (np.clip(mid, 0, 1) * 255).astype(np.uint8))


def test_two_frame_size_matches_the_jax_cli(files, tmp_path, monkeypatch):
    """--size 48 64 (enlarging): within 1 level of the JAX CLI, whose
    Pillow resize the port's resize_u8 follows within a level."""
    monkeypatch.chdir(tmp_path)
    jout, pout = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    size = ["--size", "48", "64"]
    with jax.default_matmul_precision("highest"):
        assert jax_infer_main(_two_frame_args(files, jout, size)) == 0
    assert tinfer.main(_two_frame_args(files, pout,
                                       size + ["--device", "cpu"])) == 0
    got, ref = _read_png(pout), np.asarray(Image.open(jout).convert("RGB"))
    assert got.shape == ref.shape == (48, 64, 3)
    assert _levels(got, ref) <= LEVELS


def test_two_frame_takes_png_only(files, tmp_path):
    args = _two_frame_args(files, str(tmp_path / "m.png"), ["--device", "cpu"])
    args[args.index("--frame1") + 1] = files["jpg1"]
    with pytest.raises(ValueError, match="PNG"):
        tinfer.main(args)
    with pytest.raises(ValueError, match="PNG"):
        tinfer.main(_two_frame_args(files, str(tmp_path / "m.jpg"),
                                    ["--device", "cpu"]))
    assert not os.listdir(tmp_path)


# -- video and videos ------------------------------------------------------

def _frame_count(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("compat", [False, True], ids=["bisect", "compat"])
def test_video_cli_matches_the_jax_cli(files, tmp_path, monkeypatch, capsys,
                                       compat):
    """15 fps -> factor 3: 2 pairs x 4 + 1 frames, as the JAX CLI writes."""
    monkeypatch.chdir(tmp_path)
    extra = ["--scale", "1.0", "--codec", "MJPG", "--batch_pairs", "2"] + (
        ["--reference-compat"] if compat else [])
    outs = {}
    for tag, main, dev in (("jax", jax_infer_main, []),
                           ("port", tinfer.main, ["--device", "cpu"])):
        outs[tag] = str(tmp_path / f"{tag}.avi")
        with jax.default_matmul_precision("highest"):
            assert main(["video", "--input_video", files["clip15"],
                         "--output_video", outs[tag], "--model_path",
                         files["ckpt"], "--fp32", *extra, *dev]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1] == printed[-2]       # the two stats dicts
    assert "'frames_written': 9" in printed[-1]
    assert _frame_count(outs["port"]) == _frame_count(outs["jax"]) == 9


def test_videos_cli_matches_the_jax_cli(files, tmp_path, monkeypatch, capsys):
    """Two clips (30 and 15 fps: factors 1 and 3) through one batcher."""
    monkeypatch.chdir(tmp_path)
    counts = {}
    for tag, main, dev in (("jax", jax_infer_main, []),
                           ("port", tinfer.main, ["--device", "cpu"])):
        outs = [str(tmp_path / f"{tag}{i}.avi") for i in range(2)]
        with jax.default_matmul_precision("highest"):
            assert main(["videos", "--inputs", files["clip30"],
                         files["clip15"], "--outputs", *outs,
                         "--model_path", files["ckpt"], "--fp32",
                         "--scale", "1.0", "--codec", "MJPG",
                         "--batch_pairs", "2", "--max_delay_ms", "5",
                         *dev]) == 0
        counts[tag] = [_frame_count(o) for o in outs]
    assert counts["port"] == counts["jax"] == [7, 9]
    lines = capsys.readouterr().out.strip().splitlines()
    per_clip = [ln for ln in lines if ln.startswith(files["dir"].as_posix())]
    assert per_clip[2:] == per_clip[:2]


@pytest.mark.parametrize("argv", [
    ["video", "--auto_scale", "9.0"],
    ["videos", "--auto_scale", "9.0", "--flow_prior"],
    ["two-frame", "--auto_scale", "9.0"],
], ids=["video_no_prior", "videos", "two_frame_no_prior"])
def test_auto_scale_parser_errors(files, argv):
    req = {"video": ["--input_video", "a.avi", "--output_video", "b.avi"],
           "videos": ["--inputs", "a.avi", "--outputs", "b.avi"],
           "two-frame": ["--frame0", "a.png", "--frame1", "b.png",
                         "--output", "c.png"]}[argv[0]]
    with pytest.raises(SystemExit) as e:
        tinfer.main([argv[0], *req, "--model_path", files["ckpt"],
                     "--device", "cpu", *argv[1:]])
    assert e.value.code == 2


def test_spatial_is_not_ported(files, tmp_path):
    with pytest.raises(NotImplementedError):
        tinfer.main(_two_frame_args(files, str(tmp_path / "m.png"),
                                    ["--device", "cpu", "--spatial", "2"]))


def test_flags_of_the_jax_cli_parse():
    """Every flag of the JAX CLI parses, plus --device (default cuda)."""
    common = ["--model_path", "m.npz", "--dcn_max_offset", "1",
              "--warp_max_flow", "16", "--use_pallas", "--dcn_kernel", "v5",
              "--conv_kernel", "pallas", "--dcn_tile_w", "256",
              "--max_px_per_launch", "0", "--cascade_levels", "2",
              "--flow_prior", "--flow_model", "f.npz", "--flow_prior_scale",
              "0.5", "--flow_mid_channels", "32", "--flow_levels", "3",
              "--tta", "--auto_scale", "9.0", "--fp32"]
    p = tinfer.build_parser()
    a = p.parse_args(["video", "--input_video", "a", "--output_video", "b",
                      "--bitrate", "8M", "--reference-compat",
                      "--target_fps", "60", "--max_interpolation_factor",
                      "4", "--frame_interval", "2", "--codec", "MJPG",
                      "--scale", "1.0", "--batch_pairs", "4", *common])
    assert a.device == "cuda" and a.reference_compat and a.dcn_kernel == "v5"
    a = p.parse_args(["videos", "--inputs", "a", "b", "--outputs", "c", "d",
                      "--max_delay_ms", "10", *common, "--device", "cpu"])
    assert a.device == "cpu" and a.max_delay_ms == 10.0
    a = p.parse_args(["two-frame", "--frame0", "a", "--frame1", "b",
                      "--output", "c", "--size", "360", "640", *common])
    assert a.size == [360, 640] and a.device == "cuda"


# -- checkpoint I/O --------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A random-init reference model (mid_channels=8, one block)'s state
    dict, saved as a .pth."""
    torch.manual_seed(0)
    model = EMA_VFI_Torch(mid_channels=8, num_blocks=1)
    path = str(tmp_path_factory.mktemp("pth") / "ref.pth")
    torch.save(model.state_dict(), path)
    return path, model.state_dict()


@pytest.mark.parametrize("mid,blocks", [(8, 1), (16, 2), (64, 3)])
def test_convert_ema_vfi_state_dict_matches_jax(mid, blocks):
    torch.manual_seed(mid)
    sd = {k: v.numpy() for k, v in EMA_VFI_Torch(
        mid_channels=mid, num_blocks=blocks).state_dict().items()}
    got = convert.convert_ema_vfi_state_dict(sd)
    _assert_trees_equal(got, jconvert.convert_ema_vfi_state_dict(sd))
    dims = convert.infer_model_dims(got)
    assert dims == {"in_channels": 3, "mid_channels": mid,
                    "num_blocks": blocks, "fuse_project": False}


def test_convert_ema_vfi_torch_matches_jax(pth):
    _assert_trees_equal(convert.convert_ema_vfi_torch(pth[0]),
                        jconvert.convert_ema_vfi_torch(pth[0]))


def test_pth_engine_matches_the_jax_engine(pth):
    """load_model_params of the .pth on both sides, then each package's
    float32 engine on one seed-made pair."""
    got_params = load_model_params(pth[0])
    ref_params = jax_common.load_model_params(pth[0])
    rng = np.random.default_rng(12)
    f0 = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    f1 = np.roll(f0, (1, 2), axis=(1, 2))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JFI(ref_params, bf16=False,
                             mesh=make_mesh(devices=jax.devices()[:1]))
                         .midpoints(f0, f1))
    got = FrameInterpolator(got_params, bf16=False,
                            device="cpu").midpoints(f0, f1)
    np.testing.assert_allclose(got.numpy(), ref, atol=PTH_TOL, rtol=0)


def _vgg_state_dict(prefix):
    """A torchvision vgg16 `features` state dict's conv entries (random),
    named `features.N` or bare `N`; plus a classifier entry to skip."""
    rng = np.random.default_rng(2)
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
             (256, 256), (256, 256), (256, 512), (512, 512), (512, 512)]
    sd = {}
    for idx, (ci, co) in zip(convert._VGG16_TORCH_CONV_IDX, chans):
        sd[f"{prefix}{idx}.weight"] = rng.standard_normal(
            (co, ci, 3, 3)).astype(np.float32)
        sd[f"{prefix}{idx}.bias"] = rng.standard_normal(co).astype(np.float32)
    sd["classifier.0.weight"] = np.zeros((4, 4), np.float32)
    return sd


@pytest.mark.parametrize("prefix", ["features.", ""])
def test_convert_vgg16_matches_jax(prefix, tmp_path):
    sd = _vgg_state_dict(prefix)
    _assert_trees_equal(convert.convert_vgg16_state_dict(sd),
                        jconvert.convert_vgg16_state_dict(sd))
    path = str(tmp_path / "vgg.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    _assert_trees_equal(convert.convert_vgg16_torch(path),
                        jconvert.convert_vgg16_torch(path))


def test_save_params_npz_reads_back_in_jax(files, tmp_path):
    path = str(tmp_path / "p.npz")
    convert.save_params_npz(files["params"], path)
    assert os.listdir(tmp_path) == ["p.npz"]     # no .tmp.npz left behind
    _assert_trees_equal(jconvert.load_params_npz(path), files["params"])
    _assert_trees_equal(convert.load_params_npz(path), files["params"])


def test_convert_module_writes_a_loadable_file(pth, tmp_path):
    out = str(tmp_path / "ref.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "vfi_tpu_torch.utils.convert",
                          pth[0], out], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"wrote {out}" in res.stdout
    _assert_trees_equal(jconvert.load_params_npz(out),
                        jconvert.convert_ema_vfi_torch(pth[0]))
    assert convert.main(["too", "many", "args"]) == 2


def test_load_model_params_takes_pth_pt_and_npz(pth, files, tmp_path):
    pt = str(tmp_path / "ref.pt")
    torch.save(pth[1], pt)
    for path in (pth[0], pt):
        _assert_trees_equal(load_model_params(path),
                            jconvert.convert_ema_vfi_torch(pth[0]))
    _assert_trees_equal(load_model_params(files["ckpt"]), files["params"])


# -- resize ----------------------------------------------------------------

@pytest.mark.parametrize("size", [(240, 320), (360, 640), (300, 200),
                                  (720, 1280), (500, 700)],
                         ids=["half", "shrink_wide", "shrink_odd", "enlarge",
                              "enlarge_odd"])
def test_resize_u8_matches_pillow_bilinear(size):
    img = Image.open(os.path.join(RUBBERWHALE, "frame10.png")).convert("RGB")
    ref = np.asarray(img.resize((size[1], size[0]), Image.BILINEAR))
    got = resize_u8(np.asarray(img), *size)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert _levels(got, ref) <= LEVELS
