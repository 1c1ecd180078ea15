"""A new configuration, cell, traffic kind and metric are found by name
alone: added as files and manifest entries, with no file edited."""

import json
import shutil

import pytest

from vfibench import manifest
from vfibench.manifest import REPO


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(REPO / "vfibench", tmp_path / "vfibench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_every_manifest_entry_resolves():
    man = manifest.load_manifest()
    for w in man["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell["config_spec"]["name"] == w["config"]
        assert manifest.load_driver(cell["kind"]).run
        assert cell["end_to_end"] and cell["per_layer"]
        for spec in cell["per_layer"]:
            assert manifest.load_metric(spec).read
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}


def test_added_files_are_found_without_edits(copy):
    before = {p: p.read_bytes() for p in (copy / "vfibench").rglob("*")
              if p.is_file()}
    vb = copy / "vfibench"
    cfg = json.loads((vb / "configs" / "qocc.json").read_text())
    (vb / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (vb / "workloads" / "dummy.cell-x.json").write_text(json.dumps({
        "config": "dummy", "traffic": "mix-x", "kind": "dummy_kind",
        "params": {"answer": 42}, "check": {"off2_pct": 1.0}}))
    (vb / "traffic" / "dummy_kind.py").write_text(
        "def run(ctx):\n    return ctx['params']['answer']\n")
    (vb / "metrics" / "dummy.metric-y.py").write_text(
        'LAYER = "dummy layer"\nUNIT = "%"\nSOURCE = "device_trace"\n'
        'MOVES = "frames_per_s"\nBETTER = "higher"\n'
        "def read(ctx):\n    return ctx['x']\n")
    man = json.loads((copy / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy", "source": "https://example.org",
                           "file": "vfibench/configs/dummy.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "dummy.cell-x", "config": "dummy",
                             "traffic": "mix-x", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "dummy.metric-y", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "dummy layer", "moves": "frames_per_s",
                             "workloads": ["dummy.cell-x"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(man))

    cell = manifest.load_cell("dummy.cell-x", copy)
    assert cell["config_spec"]["name"] == "dummy"
    assert manifest.load_driver(cell["kind"], copy).run(cell) == 42
    [spec] = cell["per_layer"]
    assert manifest.load_metric(spec, copy).read({"x": 7}) == 7
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_mismatch_between_file_and_manifest_is_refused(copy):
    vb = copy / "vfibench"
    spec = next(m for m in manifest.load_manifest(copy)["per_layer"]
                if m["name"] == "mfu_pct")
    bad = dict(spec, moves="latency_p95_ms")
    with pytest.raises(ValueError, match="moves"):
        manifest.load_metric(bad, copy)
    cell = json.loads((vb / "workloads" / "qocc.offline-720p-b8.json")
                      .read_text())
    cell["config"] = "q12"
    (vb / "workloads" / "qocc.offline-720p-b8.json").write_text(
        json.dumps(cell))
    with pytest.raises(ValueError, match="config"):
        manifest.load_cell("qocc.offline-720p-b8", copy)
    with pytest.raises(ValueError, match="bad"):
        manifest.load_cell("../BENCHMARK", copy)
