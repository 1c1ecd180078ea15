"""No module of the benchmark imports JAX, Flax or the JAX package
`vfi_tpu` (top-level names compared whole), and the reference imports
nothing of the program."""

import ast

from vfibench.manifest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "vfi_tpu"}


def imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere():
    files = sorted((REPO / "vfibench").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imports(f) & FORBIDDEN, f


def test_names_compared_whole():
    assert "vfi_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for f in (REPO / "vfibench" / "reference").rglob("*.py"):
        names = imports(f)
        assert "vfi_tpu_torch" not in names, f
        assert names <= {"__future__", "numpy", "torch"}, (f, names)


def test_only_program_module_imports_the_program():
    users = {f.name for f in (REPO / "vfibench").rglob("*.py")
             if "tests" not in f.parts and "vfi_tpu_torch" in imports(f)}
    assert users == {"program.py"}
