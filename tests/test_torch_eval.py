"""The port's eval CLI (`vfi_tpu_torch.cli.eval`) vs `vfi_tpu.cli.eval` on
tiny scenes of cropped val frames, through both modes: the PSNR/SSIM
sweep (qocc + flow prior, R=1, warp bound 16, float32, JAX matmuls at
HIGHEST; cascade 1, which keeps the JAX compile short) and the flow-EPE mode (the qocc flow estimator against
a cropped GT flow). Both print the same `--json` object; numbers agree to
0.01 dB PSNR, 1e-4 SSIM and 1e-3 px EPE."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vfi_tpu.cli import eval as jeval
from vfi_tpu.utils.flo import read_flo, write_flo
from vfi_tpu_torch.cli import eval as teval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QOCC = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
VAL = os.path.join(REPO, "data", "processed", "val")
TRAIN = os.path.join(REPO, "data", "processed", "train")
GT = os.path.join(REPO, "data", "processed", "other-gt-flow")
CROP = (slice(200, 264), slice(300, 428))          # 64 x 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crop_png(src, dst):
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with Image.open(src) as im:
        Image.fromarray(np.asarray(im)[CROP]).save(dst)


def _run(main, argv, capsys):
    capsys.readouterr()
    with jax.default_matmul_precision("highest"):
        assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Army: 4 frames (2 triplets), Yosemite (gray PNGs): 3 frames (1
    triplet), Teddy: 2 frames (excluded)."""
    root = tmp_path_factory.mktemp("val")
    for scene, frames in (("Army", range(7, 11)), ("Yosemite", range(7, 10)),
                          ("Teddy", range(10, 12))):
        for i in frames:
            _crop_png(os.path.join(VAL, scene, f"frame{i:02d}.png"),
                      str(root / scene / f"frame{i:02d}.png"))
    return str(root)


def test_sweep_matches_jax_cli(scenes, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)        # the JAX CLI's compilation cache
    common = ["--data-dir", scenes, "--model_path", QOCC + ".npz",
              "--flow_prior", "--dcn_max_offset", "1", "--warp_max_flow",
              "16", "--use_pallas", "--fp32",
              "--batch_size", "2", "--json"]
    ref = _run(jeval.main, common, capsys)
    got = _run(teval.main, common + ["--device", "cpu"], capsys)
    assert got.keys() == ref.keys()
    assert got["excluded_scenes"] == ref["excluded_scenes"] == ["Teddy"]
    assert got["scenes"].keys() == ref["scenes"].keys()
    for scene, r in ref["scenes"].items():
        g = got["scenes"][scene]
        assert g["n"] == r["n"]
        assert abs(g["psnr"] - r["psnr"]) < 0.01
        assert abs(g["ssim"] - r["ssim"]) < 1e-4
    assert abs(got["mean_psnr"] - ref["mean_psnr"]) < 0.01
    assert abs(got["mean_ssim"] - ref["mean_ssim"]) < 1e-4


def test_flow_mode_matches_jax_cli(capsys, monkeypatch, tmp_path):
    """RubberWhale's frames 10/11 cropped to 64 x 128; the GT flow cropped
    to 32 x 64, so the prediction is resized and rescaled to its grid."""
    frames, gt_dir = tmp_path / "frames", tmp_path / "gt"
    for i in (10, 11):
        _crop_png(os.path.join(TRAIN, "RubberWhale", f"frame{i}.png"),
                  str(frames / "RubberWhale" / f"frame{i}.png"))
    gt = read_flo(os.path.join(GT, "RubberWhale", "flow10.flo"))
    os.makedirs(gt_dir / "RubberWhale")
    write_flo(str(gt_dir / "RubberWhale" / "flow10.flo"),
              gt[200:232, 300:364])
    monkeypatch.chdir(tmp_path)
    common = ["--data-dir", str(frames), "--flow_model",
              QOCC + ".flow.npz", "--gt_flow_dir", str(gt_dir), "--fp32",
              "--json"]
    ref = _run(jeval.main, common, capsys)
    got = _run(teval.main, common + ["--device", "cpu"], capsys)
    assert got.keys() == ref.keys() and got["scenes"].keys() == {"RubberWhale"}
    assert abs(got["mean_epe"] - ref["mean_epe"]) < 1e-3


def test_auto_scale_needs_flow_prior(scenes):
    with pytest.raises(SystemExit):
        teval.main(["--data-dir", scenes, "--model_path", QOCC + ".npz",
                    "--auto_scale", "9.0", "--device", "cpu"])


@pytest.mark.parametrize("path,exc", [("ckpt.pth", NotImplementedError),
                                      ("ckpt.bin", ValueError)])
def test_load_model_params_takes_npz_only(path, exc):
    from vfi_tpu_torch.cli.common import load_model_params

    with pytest.raises(exc):
        load_model_params(path)
