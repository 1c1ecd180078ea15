"""A run's correctness check: a sound run on the CPU at a tiny size comes
out correct; with the timed path broken underneath it does not; the
control (the reference in float8) reads above each cell's limit.

The harness's look for a card is skipped (`run_cell` with the CPU); the
rest of a run is driven as on the card: the traffic driver, the seeded
sample, the reference, the limits. The faults an inference cell can have:
an answer altered where it is produced, and half of the batch left out
(every other pair's answer copied from its neighbour). A cell on one card has no
exchange between cards and no training state to leave unchanged.
"""

import json
import time

import numpy as np
import pytest
import torch

from vfibench.check import off2_pct, reference_midpoints
from vfibench.inputs import make_pool
from vfibench.manifest import REPO, load_cell, load_manifest
from vfibench.run import run_cell

# The serving cell's files are kept while the cell is out of the manifest
# (PERF.md, Open questions); these are the entries that bring it back.
SERVE = "qocc.serve-720p-open"
SERVE_ENTRIES = {
    "workloads": [{"name": SERVE, "config": "qocc",
                   "traffic": "serve-720p-open", "chips": 1, "why": "-"}],
    "end_to_end": [{"name": n, "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": [SERVE]}
                   for n in ("latency_p95_ms", "latency_p50_ms")],
    "per_layer": [
        {"name": "serve_batch_mean", "unit": "requests", "better": "higher",
         "source": "program_counter", "layer": "serve: serve/batcher.py",
         "moves": "latency_p95_ms", "workloads": [SERVE]},
        {"name": "serve_worker_busy_pct", "unit": "%", "better": "lower",
         "source": "host_clock", "layer": "serve worker to engine",
         "moves": "latency_p95_ms", "workloads": [SERVE]}],
}
CELLS = [w["name"] for w in load_manifest()["workloads"]] + [SERVE]


def cell_of(name, tmp_path_factory):
    if name != SERVE:
        return load_cell(name)
    root = tmp_path_factory.mktemp("manifest")
    man = load_manifest()
    for key, entries in SERVE_ENTRIES.items():
        man[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (root / "vfibench").symlink_to(REPO / "vfibench")
    return load_cell(name, root)


@pytest.fixture
def small(tmp_path_factory):
    def make(name):
        return shrink(cell_of(name, tmp_path_factory))
    return make


def shrink(cell):
    cell["params"].update(size=[48, 80], crop=[240, 400], pool=4, batch=2,
                          warmup_calls=1)
    return cell


def run(cell):
    return run_cell(cell, 2 ** 40 + 17, 1.0, False, "cpu",
                    time.perf_counter())


@pytest.fixture
def broken(monkeypatch):
    from vfi_tpu_torch.infer.pair import FrameInterpolator

    real = FrameInterpolator.midpoints

    def use(kind):
        def midpoints(self, f0, f1):
            if kind == "altered":         # the first answer: its first frame
                out = real(self, f0, f1).clone()
                out[0] = torch.as_tensor(np.asarray(f0[0]))
                return out
            # half of the batch left out: every other pair is not computed
            # and takes its neighbour's answer (the first pair of a padded
            # serving batch is always a request)
            out = real(self, f0[0::2], f1[0::2])
            return out.repeat_interleave(2, dim=0)[:len(f0)]
        monkeypatch.setattr(FrameInterpolator, "midpoints", midpoints)
    return use


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, small):
    out = run(small(name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("kind", ["altered", "half"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, kind, broken, small):
    broken(kind)
    out = run(small(name))
    assert not out["correct"], out["checks"]
    c = out["checks"]["off2_pct"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name, tmp_path_factory):
    cell = cell_of(name, tmp_path_factory)
    p = cell["params"]
    pool = make_pool(5, 2, (180, 320), tuple(p["crop"]))
    ref = reference_midpoints(cell["config_spec"], pool, [0, 1], "cpu")
    ctl = reference_midpoints(cell["config_spec"], pool, [0, 1], "cpu",
                              precision="fp8")
    worst = max(off2_pct(ctl[i], ref[i]) for i in (0, 1))
    assert worst > cell["check"]["off2_pct"], worst
