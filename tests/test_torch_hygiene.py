"""The port stands alone: no module of vfi_tpu_torch, and not
chip_smoke.py, imports jax, flax, the JAX package, tools/, PIL or cv2 (the
card's machine has none of them), except that the video file I/O
(`infer/video_io.py`) imports cv2 inside its functions; importing the port
loads none of them; entry points refuse to run without a card unless the
caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "vfi_tpu", "tools",
          "PIL", "cv2")


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


# The one module that may import cv2, and only inside a function body:
# importing the port (and running chip_smoke.py) loads no cv2.
CV2_MODULE = os.path.join(REPO, "vfi_tpu_torch", "infer", "video_io.py")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    banned = (tuple(b for b in BANNED if b != "cv2") if path == CV2_MODULE
              else BANNED)
    bad = sorted({r for r in _imported_roots(path) if r in banned})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_cv2_is_imported_inside_functions_only():
    tree = ast.parse(open(CV2_MODULE).read(), filename=CV2_MODULE)
    inside = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside |= {id(n) for n in ast.walk(fn)}
    cv2_imports = [n for n in ast.walk(tree)
                   if (isinstance(n, ast.Import)
                       and any(a.name.split(".")[0] == "cv2"
                               for a in n.names))
                   or (isinstance(n, ast.ImportFrom) and n.level == 0
                       and n.module.split(".")[0] == "cv2")]
    assert cv2_imports, "the video file I/O reads files with cv2"
    outside = [n.lineno for n in cv2_imports if id(n) not in inside]
    assert not outside, f"cv2 imported at module level: lines {outside}"


def test_import_leaves_jax_out():
    code = ("import sys, vfi_tpu_torch, vfi_tpu_torch.infer, "
            "vfi_tpu_torch.ops.cuda, vfi_tpu_torch.models, "
            "vfi_tpu_torch.data, vfi_tpu_torch.cli.eval, "
            "vfi_tpu_torch.serve, vfi_tpu_torch.cli.serve, "
            "vfi_tpu_torch.tools.bench_serve, vfi_tpu_torch.infer.video, "
            "vfi_tpu_torch.infer.multi, vfi_tpu_torch.infer.video_io, "
            "vfi_tpu_torch.cli.infer, vfi_tpu_torch.utils.convert;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'vfi_tpu', 'triton', 'PIL', 'cv2')];"
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
