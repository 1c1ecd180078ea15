"""Finds a cell's pieces by name.

`BENCHMARK.json` at the repository root lists the configurations, cells
(`workloads`) and metrics. Everything that belongs to one of them sits in
files of its own under `vfibench/`, found by the name alone:

- `configs/<config>.json`: checkpoint, engine settings, widths, source;
- `workloads/<cell>.json`: the configuration, the traffic mix, the
  traffic driver (`kind`) and its parameters, the correctness limits;
- `traffic/<kind>.py`: the driver of a kind of traffic (`run(ctx)`);
- `metrics/<metric>.py`: the reader of a per-layer metric (`read(ctx)`).

Adding a cell or a metric is adding files and manifest entries; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
METRIC_DECL = ("layer", "unit", "source", "moves", "better")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_manifest(root: Path = REPO) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} {name!r} in BENCHMARK.json")


def _module(path: Path, label: str):
    """Import a file by its path (names may hold '.' and '-')."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = REPO) -> dict:
    """The cell's manifest entry merged with its workload file, and its
    configuration under `config_spec`."""
    man = load_manifest(root)
    entry = _entry(man["workloads"], _name("cell", name), "workload")
    cell = json.loads(
        (root / "vfibench" / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} {cell[key]!r} in the workload "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    cell.update(name=name, chips=entry["chips"], why=entry["why"])
    cell["config_spec"] = load_config(cell["config"], root)
    cell["end_to_end"] = [m for m in man["end_to_end"]
                          if name in m.get("workloads", [name])]
    cell["per_layer"] = [m for m in man["per_layer"]
                         if name in m.get("workloads", [name])]
    return cell


def load_config(name: str, root: Path = REPO) -> dict:
    man = load_manifest(root)
    entry = _entry(man["configs"], _name("config", name), "config")
    cfg = json.loads((root / entry["file"]).read_text())
    cfg.update(name=name, reduced=entry["reduced"])
    return cfg


def load_driver(kind: str, root: Path = REPO):
    return _module(root / "vfibench" / "traffic" / f"{_name('traffic kind', kind)}.py",
                   f"vfibench_traffic_{kind}")


def load_metric(spec: dict, root: Path = REPO):
    """The reader of the per-layer metric `spec` (a manifest entry); its
    declared layer, unit, source, moves and better must match the
    manifest's."""
    name = _name("metric", spec["name"])
    mod = _module(root / "vfibench" / "metrics" / f"{name}.py",
                  f"vfibench_metric_{name}")
    for key in METRIC_DECL:
        if getattr(mod, key.upper()) != spec[key]:
            raise ValueError(f"metric {name}: {key} "
                             f"{getattr(mod, key.upper())!r} in its file, "
                             f"{spec[key]!r} in BENCHMARK.json")
    return mod
