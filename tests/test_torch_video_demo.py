"""The port's clip up-conversion demo (`vfi_tpu_torch.tools.video_demo`)
against the JAX package's `tools/video_demo.py`: the synthesized clip
decodes to the same frames, the flags are the JAX tool's plus `--device`
and `--smoke`, and `--smoke` runs end to end on the CPU (a tiny
random-weight checkpoint saved through the port's `save_params_npz`,
every file under `tmp_path`) into a record with the JAX tool's keys and
the recursion's frame count."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from tools import video_demo as jdemo
from vfi_tpu_torch.infer.pair import pick_interpolation_factor
from vfi_tpu_torch.models import EMAVFI
from vfi_tpu_torch.tools import video_demo
from vfi_tpu_torch.utils.convert import params_to_jax, save_params_npz

# The JAX tool's report (tools/video_demo.py), field for field.
JAX_KEYS = {"resolution", "in_frames", "in_fps", "out_frames", "output_fps",
            "interpolated_frames", "wall_s", "interpolated_frames_per_sec",
            "scale", "model_path", "note"}


def _decoded(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def test_synthesize_clip_makes_the_jax_tools_frames(tmp_path):
    ours, theirs = str(tmp_path / "ours.mp4"), str(tmp_path / "jax.mp4")
    video_demo.synthesize_clip(ours, 170, 200, 4, 15.0)
    jdemo.synthesize_clip(theirs, 170, 200, 4, 15.0)
    a, b = _decoded(ours), _decoded(theirs)
    assert a.shape == (4, 170, 200, 3)
    np.testing.assert_array_equal(a, b)
    assert video_demo.count_frames(ours) == jdemo.count_frames(theirs)


def test_flags_are_the_jax_tools_and_the_default_record_is_the_ports():
    args = vars(video_demo.parse_args(["--model_path", "m.npz"]))
    jax_flags = {"height", "width", "frames", "fps", "target_fps",
                 "model_path", "flow_model", "scale", "batch_pairs", "radius",
                 "dcn_tile_w", "workdir", "out_json"}
    assert set(args) == jax_flags | {"device", "smoke"}
    assert args["device"] == "cuda"
    name = os.path.basename(args["out_json"])
    assert os.path.dirname(args["out_json"]) == "artifacts"
    assert not name.startswith("video_upconv_")


def test_smoke_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.manual_seed(0)
    ckpt, out = str(tmp_path / "tiny.npz"), str(tmp_path / "demo.json")
    save_params_npz(params_to_jax(EMAVFI(mid_channels=8,
                                         num_blocks=1).state_dict()), ckpt)
    report = video_demo.main(["--smoke", "--model_path", ckpt, "--workdir",
                              str(tmp_path / "work"), "--out_json", out])
    assert json.load(open(out)) == report
    assert set(report) == JAX_KEYS
    smoke = video_demo.SMOKE
    factor, fps = pick_interpolation_factor(smoke["fps"],
                                            smoke["target_fps"])
    assert factor == 3      # two bisection levels of the recursion
    n = smoke["frames"]
    assert report["out_frames"] == (n - 1) * (factor + 1) + 1
    assert report["interpolated_frames"] == report["out_frames"] - n
    assert report["output_fps"] == pytest.approx(fps)
    assert report["resolution"] == f"{smoke['width']}x{smoke['height']}"
    assert "cpu" in report["note"]
