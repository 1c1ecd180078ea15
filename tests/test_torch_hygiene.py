"""The port stands alone: no module of vfi_tpu_torch, and not
chip_smoke.py, imports jax, flax, the JAX package or tools/; importing the
port loads no jax; entry points refuse to run without a card unless the
caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "vfi_tpu", "tools")


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


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in BANNED})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys, vfi_tpu_torch, vfi_tpu_torch.infer, "
            "vfi_tpu_torch.ops.cuda, vfi_tpu_torch.models;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'vfi_tpu', 'triton')];"
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_import_builds_nothing():
    from vfi_tpu_torch.ops.cuda import build

    assert build._lib is None


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
