"""The port stands alone: no module of vfi_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax, orbax, the JAX package, tools/,
PIL, cv2 or yaml (the card's machine has none of the first ones and need
not have pyyaml), except that the video file I/O (`infer/video_io.py`)
and the clip demo (`tools/video_demo.py`) import cv2, and the training
config (`utils/config.py`) yaml, inside their functions; importing the port loads none of them; entry points
refuse to run without a card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "vfi_tpu", "tools",
          "PIL", "cv2", "yaml")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vfi_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# The modules that may import one of these, each only inside a function
# body: importing the port (and running chip_smoke.py) loads neither. The
# card's machine has no cv2 (video file I/O) and need not have pyyaml (a
# YAML training config).
INSIDE_ONLY = {
    "cv2": (os.path.join(REPO, "vfi_tpu_torch", "infer", "video_io.py"),
            os.path.join(REPO, "vfi_tpu_torch", "tools", "video_demo.py")),
    "yaml": (os.path.join(REPO, "vfi_tpu_torch", "utils", "config.py"),),
}


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    banned = tuple(b for b in BANNED if path not in INSIDE_ONLY.get(b, ()))
    bad = sorted({r for r in _imported_roots(path) if r in banned})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_spawned_worker_helper_imports_no_jax():
    """The multi-process tests' workers (`tests/torch_dist_case.py`) run in
    spawned ranks, which import that module alone: it imports neither jax
    nor the JAX package, and importing it loads neither."""
    path = os.path.join(REPO, "tests", "torch_dist_case.py")
    bad = sorted({r for r in _imported_roots(path) if r in BANNED})
    assert not bad, f"tests/torch_dist_case.py imports {bad}"
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_dist_case;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'vfi_tpu')]; assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_inside_functions_only(root, path):
    tree = ast.parse(open(path).read(), filename=path)
    inside = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside |= {id(n) for n in ast.walk(fn)}
    imports = [n for n in ast.walk(tree)
               if (isinstance(n, ast.Import)
                   and any(a.name.split(".")[0] == root for a in n.names))
               or (isinstance(n, ast.ImportFrom) and n.level == 0
                   and n.module.split(".")[0] == root)]
    assert imports, f"{os.path.relpath(path, REPO)} imports {root}"
    outside = [n.lineno for n in imports if id(n) not in inside]
    assert not outside, f"{root} imported at module level: lines {outside}"


@pytest.mark.parametrize("path", INSIDE_ONLY["cv2"],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_cv2_is_imported_inside_functions_only(path):
    _imported_inside_functions_only("cv2", path)


def test_yaml_is_imported_inside_functions_only():
    _imported_inside_functions_only("yaml", *INSIDE_ONLY["yaml"])


def test_import_leaves_jax_out():
    code = ("import sys, vfi_tpu_torch, vfi_tpu_torch.infer, "
            "vfi_tpu_torch.ops.cuda, vfi_tpu_torch.models, "
            "vfi_tpu_torch.data, vfi_tpu_torch.cli.eval, "
            "vfi_tpu_torch.serve, vfi_tpu_torch.cli.serve, "
            "vfi_tpu_torch.tools.bench_serve, vfi_tpu_torch.infer.video, "
            "vfi_tpu_torch.infer.multi, vfi_tpu_torch.infer.video_io, "
            "vfi_tpu_torch.cli.infer, vfi_tpu_torch.utils.convert, "
            "vfi_tpu_torch.losses, vfi_tpu_torch.models.vgg, "
            "vfi_tpu_torch.data.loader, vfi_tpu_torch.utils.config, "
            "vfi_tpu_torch.train, vfi_tpu_torch.cli.train, "
            "vfi_tpu_torch.parallel, vfi_tpu_torch.tools.video_demo;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'vfi_tpu', 'triton', 'PIL', "
            "'cv2', 'yaml')];"
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_import_builds_nothing():
    from vfi_tpu_torch import native
    from vfi_tpu_torch.ops.cuda import build

    assert build._lib is None
    code = ("import vfi_tpu_torch.data, vfi_tpu_torch.cli.eval;"
            "from vfi_tpu_torch import native; assert native._lib is None")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert native.SRC.is_file()


def test_eval_cli_needs_a_card_unless_asked_for_cpu(monkeypatch):
    from vfi_tpu_torch.cli import eval as teval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = os.path.join(REPO, "artifacts", "emavfi_qocc_best")
    with pytest.raises(RuntimeError):
        teval.main(["--data-dir", os.path.join(REPO, "data", "processed",
                                               "val"),
                    "--model_path", ckpt + ".npz", "--dcn_max_offset", "1"])
    with pytest.raises(RuntimeError):
        teval.main(["--data-dir", ".", "--flow_model", ckpt + ".flow.npz"])


def test_serve_cli_needs_a_card_unless_asked_for_cpu(monkeypatch):
    from vfi_tpu_torch.cli import serve as tserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model_path", os.path.join(REPO, "artifacts",
                                         "emavfi_qocc_best.npz"),
            "--port", "0"]
    with pytest.raises(RuntimeError):
        tserve.build_server(argv)
    server = tserve.build_server(argv + ["--device", "cpu"]).start()
    server.shutdown()
    assert server.batcher.engine.device == torch.device("cpu")


@pytest.mark.parametrize("cmd", ["two-frame", "video", "videos"])
def test_infer_cli_needs_a_card_unless_asked_for_cpu(cmd, monkeypatch,
                                                     tmp_path):
    """Every subcommand raises RuntimeError without a card, and runs on the
    CPU when asked (tiny inputs: a 16x24 PNG pair, 3-frame MJPG clips)."""
    import cv2
    import numpy as np

    from vfi_tpu_torch import native
    from vfi_tpu_torch.cli import infer as tinfer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    png, clip = str(tmp_path / "a.png"), str(tmp_path / "a.avi")
    with open(png, "wb") as f:
        f.write(native.encode_png_rgb(frame))
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                             (24, 16))
    for i in range(3):
        writer.write(np.roll(frame, i, axis=1))
    writer.release()
    ckpt = os.path.join(REPO, "artifacts", "emavfi_qocc_best.npz")
    out = str(tmp_path / ("m.png" if cmd == "two-frame" else "m.avi"))
    video = ["--scale", "1.0", "--codec", "MJPG"]
    io = {"two-frame": ["--frame0", png, "--frame1", png, "--output", out],
          "video": ["--input_video", clip, "--output_video", out, *video],
          "videos": ["--inputs", clip, "--outputs", out, *video]}[cmd]
    argv = [cmd, *io, "--model_path", ckpt, "--dcn_max_offset", "1",
            "--warp_max_flow", "16"]
    with pytest.raises(RuntimeError):
        tinfer.main(argv)
    assert not os.path.exists(out)
    assert tinfer.main(argv + ["--device", "cpu"]) == 0
    assert os.path.getsize(out) > 0


def test_trainer_and_train_cli_need_a_card_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """Trainer() and the train CLI raise RuntimeError without a card; the
    CLI asked for the CPU gets past the device (and then fails on the
    missing data directory)."""
    from vfi_tpu_torch.cli import train as tcli
    from vfi_tpu_torch.train import Trainer
    from vfi_tpu_torch.utils.config import TrainConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "none")
    cfg = TrainConfig(train_data_dir=missing, val_data_dir=missing,
                      checkpoint_path=str(tmp_path / "c"),
                      output_image_path=str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    argv = ["--train_data_dir", missing, "--val_data_dir", missing,
            "--checkpoint_path", str(tmp_path / "c")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    with pytest.raises(FileNotFoundError):
        tcli.main(argv + ["--device", "cpu"])


def test_engine_needs_a_card_unless_asked_for_cpu(monkeypatch):
    from vfi_tpu_torch.infer import FrameInterpolator, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        FrameInterpolator({"params": {}})
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card():
    """No card: chip_smoke exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied into a directory with nothing else of the repo
    cannot run."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(dst)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
