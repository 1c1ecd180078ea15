"""The port's kernel tools (`vfi_tpu_torch.tools.bench_conv`,
`bench_kernels`, `conv_turns`) in their `--device cpu --smoke` mode, which
runs every kernel name through its CPU route (the plain versions), and
`utils/profiling` (`StepTimer`, `trace`) against the reference's
`vfi_tpu/utils/profiling.py`."""

import json
import os

import numpy as np
import pytest
import torch

from vfi_tpu.utils.profiling import StepTimer as JaxStepTimer
from vfi_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from vfi_tpu_torch.tools import (bench_conv, bench_kernels, conv_turns,
                                 time_interleaved)
from vfi_tpu_torch.utils.profiling import StepTimer, trace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_conv_smoke_runs_every_kernel_on_the_cpu(capsys):
    reset_launch_counts()
    res = bench_conv.main(["--device", "cpu", "--smoke", "--shapes", "all",
                           "--kernels", "xla,im2col,direct,v2,plain",
                           "--iters", "2"])
    assert _last_json(capsys) == res
    assert (res["device"], res["h"], res["w"]) == ("cpu", 8, 16)
    rows = {(r["cin"], r["cout"], r["kernel"]): r for r in res["rows"]}
    assert len(rows) == 4 * 5
    # v2 keeps conv2d_pallas_v2's refusal of 6 channels; the rest run
    assert "refused" in rows[(6, 64, "v2")]
    for key, r in rows.items():
        if key != (6, 64, "v2"):
            assert r["ms"] > 0 and np.isfinite(r["tflops"])
    # the kernel names are the plain version on the CPU: equal outputs
    for (cin, cout, k), r in rows.items():
        if k in ("im2col", "direct", "plain") or (k == "v2" and cin != 6):
            assert r["max_abs_err"] == 0.0
    assert launch_counts()["conv2d"] == 0


@pytest.mark.parametrize("kernels", ["xla,pallas,v4,v5", "pallas"])
def test_bench_kernels_dcn_smoke(capsys, kernels):
    res = bench_kernels.main(["--device", "cpu", "--smoke", "--kernels",
                              kernels, "--iters", "2", "--radius", "3"])
    assert _last_json(capsys) == res
    assert (res["mode"], res["channels"], res["radius"]) == ("dcn", 8, 3)
    names = {bench_kernels.DCN_KERNELS[k] for k in kernels.split(",")}
    got = {(r["regime"], r["kernel"]) for r in res["rows"]}
    assert got == {(reg, n) for reg in ("zero", "trained", "worst")
                   for n in names}
    assert all(r["max_abs_err"] == 0.0 and r["ms"] > 0 for r in res["rows"])


def test_bench_kernels_reads_real_offset_planes(tmp_path, capsys):
    """--offsets takes the npz tools/dump_offsets.py writes."""
    rng = np.random.default_rng(0)
    path = tmp_path / "planes.npz"
    np.savez(path, **{f"offset_l{i}": rng.uniform(-1, 1, (1, 8, 16, 18))
                      for i in range(2)},
             **{f"mask_l{i}": rng.uniform(0, 1, (1, 8, 16, 9))
                for i in range(2)})
    res = bench_kernels.main(["--device", "cpu", "--smoke", "--offsets",
                              str(path), "--iters", "1"])
    assert {r["regime"] for r in res["rows"]} == {"real:l0", "real:l1"}
    bad = tmp_path / "bad.npz"
    np.savez(bad, offset_l0=np.zeros((1, 4, 4, 18)),
             mask_l0=np.zeros((1, 4, 4, 9)))
    with pytest.raises(SystemExit):
        bench_kernels.main(["--device", "cpu", "--smoke", "--offsets",
                            str(bad)])
    capsys.readouterr()


def test_bench_kernels_refuses_the_tpu_only_variants(capsys):
    with pytest.raises(SystemExit):
        bench_kernels.main(["--device", "cpu", "--smoke", "--kernels",
                            "v4t"])


def test_bench_kernels_warp_smoke(capsys):
    res = bench_kernels.main(["--device", "cpu", "--smoke", "--warp",
                              "--iters", "2"])
    assert _last_json(capsys) == res
    assert res["mode"] == "warp" and res["radius"] == bench_kernels.WARP_R
    got = {(r["channels"], r["flow"], r["kernel"]) for r in res["rows"]}
    assert got == {(c, f, k) for c in bench_kernels.WARP_CHANNELS
                   for f in ("smooth3", "smooth10", "random")
                   for k in ("plain", "grid_sample", "bounded_warp")}
    for r in res["rows"]:
        if r["kernel"] == "bounded_warp":
            assert r["max_abs_err"] == 0.0


@pytest.mark.parametrize("tool", [bench_conv, bench_kernels])
def test_tools_run_on_the_card_unless_asked_for_the_cpu(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--smoke"])


def test_time_interleaved_takes_turns_and_returns_medians():
    calls = []
    fns = {"a": lambda: calls.append("a"), "b": lambda: calls.append("b")}
    ms = time_interleaved(fns, 3, torch.device("cpu"), warmup=1)
    assert set(ms) == {"a", "b"} and all(v >= 0 for v in ms.values())
    assert calls == ["a", "b"] * 4


def test_step_timer_reports_as_the_reference():
    """Same sections, counts and report layout as the JAX package's
    StepTimer, from the same recorded times."""
    ours, ref = StepTimer(), JaxStepTimer()
    for timer in (ours, ref):
        for _ in range(3):
            with timer.section("step"):
                pass
        timer.sections["step"] = [0.010, 0.020, 0.030]
        with timer.section("data"):
            pass
    assert ours.report().splitlines()[0] == ref.report().splitlines()[0]
    assert ours.report().splitlines()[0] == (
        "step: p50 20.0 ms  p90 28.0 ms  mean 20.0 ms  n=3")
    assert ours.mean("step") == pytest.approx(ref.mean("step"))
    assert np.isnan(ours.mean("missing"))


def test_step_timer_synchronises_the_named_device(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    with StepTimer(device="cuda").section("step"):
        pass
    with StepTimer().section("step"):
        pass
    assert synced == ["cuda", "cuda"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(8).add_(1)
    events = json.load(open(tmp_path / "prof" / "trace.json"))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert events["traceEvents"]


def test_conv_turns_smoke_times_each_tree_in_turn(capsys):
    """Two turns of this checkout: one row per (turn, shape), the same
    outputs in both (the plain versions on the CPU), a median per tree."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = conv_turns.main(["--trees", f"{root},{root}", "--device", "cpu",
                           "--smoke", "--shapes", "16x8,16x27c"])
    assert _last_json(capsys) == res
    assert [(r["turn"], r["shape"]) for r in res["rows"]] == [
        (0, "16x8"), (0, "16x27c"), (1, "16x8"), (1, "16x27c")]
    assert res["rows"][0]["checksum"] == res["rows"][2]["checksum"]
    assert all(r["ms"] > 0 for r in res["rows"])
    assert set(res["median_ms"][root]) == {"16x8", "16x27c"}


def test_conv_turns_times_the_warp_and_copy_tokens(capsys):
    """`warpCrR` warps a C-channel image by random flows, `:zero` by a
    zero flow, which returns the image itself; `copyC` clones the same
    image (the seeded inputs are the same in every token)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shapes = ["warp64r16", "warp64r16:zero", "copy64"]
    res = conv_turns.main(["--trees", root, "--device", "cpu", "--smoke",
                           "--shapes", ",".join(shapes)])
    assert _last_json(capsys) == res
    sums = {r["shape"]: r["checksum"] for r in res["rows"]}
    assert list(sums) == shapes and all(r["ms"] > 0 for r in res["rows"])
    assert sums["warp64r16:zero"] == sums["copy64"] != sums["warp64r16"]


def test_conv_turns_times_the_chain_tokens(capsys):
    """`chain_NAME[:HOW]` drives a trunk chain (feat, motion, rec, rec67)
    on the checkout's route, each route forced, and cuDNN layer by layer;
    on the CPU the kernel routes run the plain version (the same output in
    every turn and route) and the cuDNN sequence runs bf16 convs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shapes = [f"chain_{n}{how}" for n in ("feat", "motion", "rec", "rec67")
              for how in ("", ":fused", ":layers", ":cudnn")]
    reset_launch_counts()
    res = conv_turns.main(["--trees", f"{root},{root}", "--device", "cpu",
                           "--smoke", "--shapes", ",".join(shapes)])
    assert _last_json(capsys) == res
    rows = res["rows"]
    assert [r["shape"] for r in rows] == shapes * 2
    for a, b in zip(rows[:len(shapes)], rows[len(shapes):]):
        assert a["checksum"] == b["checksum"] and a["checksum"] > 0
    for i in range(0, len(shapes), 4):
        own, fused, layers, cudnn = (r["checksum"] for r in rows[i:i + 4])
        assert own == fused == layers
        assert cudnn == pytest.approx(own, rel=2e-2)
    assert set(res["median_ms"][root]) == set(shapes)
    assert sum(launch_counts().values()) == 0   # children, not this process


def test_conv_turns_times_the_dcn_and_warp_tokens(capsys):
    """`dcnCrR` and `warpCrR` drive the bounded DCN (C -> C at radius R)
    and the bounded warp of a C-channel image, `dcnCrR:stream` the DCN on
    the stream design at a shape the plan gives the tile design; on the
    CPU their plain versions, the same output in every turn and design."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shapes = ["dcn64r1", "dcn67r2", "warp3r16", "dcn64r1:stream"]
    reset_launch_counts()
    res = conv_turns.main(["--trees", f"{root},{root}", "--device", "cpu",
                           "--smoke", "--shapes", ",".join(shapes)])
    assert _last_json(capsys) == res
    assert [r["shape"] for r in res["rows"]] == shapes * 2
    for a, b in zip(res["rows"][:4], res["rows"][4:]):
        assert a["checksum"] == b["checksum"] and a["checksum"] > 0
    assert res["rows"][0]["checksum"] == res["rows"][3]["checksum"]
    assert set(res["median_ms"][root]) == set(shapes)
    assert sum(launch_counts().values()) == 0   # children, not this process
