"""The port's user tools (`vfi_tpu_torch.tools.profile_forward`,
`dump_offsets`, `offset_stats`, `bench_flowprior`, `bench_train_step`) and
the profiler's breakdown (`utils.profiling`) against the JAX package's
`tools/` on the CPU: the interval union and timeline against
`tools/profile_forward.py`'s, the category of fixed kernel names and
the count of the port's kernels among a trace's device events, the
offset planes against the JAX model's `capture_intermediates` on a tiny
random model (float32, JAX at HIGHEST precision, within 1e-5), `pair_stats`
against `tools/offset_stats.py`'s bit for bit, the training config
against `config/train_config.yaml`; then each tool's `--device cpu
--smoke` run and its refusal without a card."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.models import EMAVFI as JEMAVFI
from vfi_tpu_torch.models import EMAVFI
from vfi_tpu_torch.tools import (bench_flowprior, bench_kernels,
                                 bench_train_step, dump_offsets,
                                 offset_stats, profile_forward)
from vfi_tpu_torch.utils.config import load_train_config
from vfi_tpu_torch.utils.convert import params_from_jax
from vfi_tpu_torch.utils.profiling import (CATEGORIES, category,
                                           device_profile,
                                           port_kernel_counts, timeline,
                                           union_ms)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANE_TOL = 1e-5
TOOLS = [profile_forward, dump_offsets, offset_stats, bench_flowprior,
         bench_train_step]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU at
    once, and torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _intervals(rng, n, cats=None):
    """n random (start, end) in integer microseconds, some nested, some
    overlapping, some apart; with `cats`, a category each."""
    starts = np.sort(rng.integers(0, 5000, n))
    ends = starts + rng.integers(1, 400, n)
    iv = [(int(s), int(e)) for s, e in zip(starts, ends)]
    if cats is None:
        return iv
    return [(s, e, cats[i % len(cats)]) for i, (s, e) in enumerate(iv)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_and_timeline_match_the_jax_tool(seed):
    from tools.profile_forward import _union_ms, timeline as j_timeline

    rng = np.random.default_rng(seed)
    iv = _intervals(rng, 60)
    # the JAX tool reads picoseconds, the profiler microseconds
    assert union_ms(iv) == pytest.approx(
        _union_ms([(s * 10**6, e * 10**6) for s, e in iv]), rel=1e-12)
    events = _intervals(rng, 80, ["port-kernels", "gemm", "layout"])
    got = timeline(events)
    ref = j_timeline([(s * 10**6, e * 10**6, c) for s, e, c in events])
    assert got[0].keys() == ref[0].keys()
    for c in ref[0]:
        assert got[0][c] == pytest.approx(ref[0][c], rel=1e-12)
    assert got[1:] == pytest.approx(ref[1:], rel=1e-12)
    by_cat, busy, wall = got
    overlap, idle = sum(by_cat.values()) - busy, wall - busy
    assert sum(by_cat.values()) - overlap + idle == pytest.approx(wall)


KERNEL_NAMES = [
    ("void dcn_tile_kernel<64, 16>(DcnArgs)", "port-kernels"),
    ("void conv2d_kernel<2, 64>(Conv2dArgs)", "port-kernels"),
    ("void warp_bounded_kernel<__nv_bfloat16>(WarpArgs)", "port-kernels"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "layout"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32", "convolution"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "gemm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, 128>",
     "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, "
     "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>",
     "layout"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor>>>",
     "reduce"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "layout"),
    ("Memcpy HtoD (Pageable -> Device)", "layout"),
    ("Memset (Device)", "layout"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
     "collectives"),
    ("void at::native::indexFuncLargeIndex<float, long>", "other"),
    ("aten::conv2d", "convolution"),
    ("aten::matmul", "gemm"),
    ("aten::copy_", "layout"),
    ("aten::cat", "layout"),
    ("aten::sigmoid", "other"),
]


def test_category_sorts_kernel_names():
    got = [(name, category(name)) for name, _ in KERNEL_NAMES]
    assert got == KERNEL_NAMES
    assert {c for _, c in KERNEL_NAMES} == set(CATEGORIES)


class _Ev:
    def __init__(self, name, device_type):
        self.name, self.device_type = name, device_type


def test_port_kernel_counts_counts_each_kernel_of_the_sources():
    """Every `__global__` of csrc/*.cu, as a trace names it, counts under
    its own name; no other kernel counts, nor a host op of that name."""
    src = os.path.join(os.path.dirname(profile_forward.__file__), "..",
                       "csrc")
    names = sorted({n for f in os.listdir(src) if f.endswith(".cu")
                    for n in re.findall(r"^(\w+_kernel)\(",
                                        open(os.path.join(src, f)).read(),
                                        re.M)})
    assert len(names) >= 11
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Ev(f"void {n}<64, 2>({n[:4]}Params)", cuda)
              for n in names for _ in range(2)]
    events += [_Ev(n, cuda) for n, c in KERNEL_NAMES
               if c != "port-kernels"]
    events += [_Ev(names[0], cpu)]
    assert port_kernel_counts(events) == {n: 2 for n in names}


def test_device_profile_on_the_cpu_adds_up():
    x = torch.randn(64, 64)
    res = device_profile(lambda: (x @ x).relu().sum(), "cpu")
    rows = (sum(res["timeline_ms"].values())
            - res["cross_category_overlap_ms"] + res["idle_ms"])
    assert rows == pytest.approx(res["trace_span_ms"])
    assert sum(res["category_ms"].values()) == pytest.approx(
        res["device_kernel_ms"])
    assert res["port_kernels_ms"] == 0 and res["kernel_launches"] > 0
    assert res["category_ms"]["gemm"] > 0


def _tiny_pair():
    rng = np.random.default_rng(3)
    f0 = rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    return f0, np.roll(f0, (1, 2), axis=(1, 2))


def _jax_planes(params, model, f0, f1):
    """The JAX tool's planes (tools/dump_offsets.py), in float32."""
    with jax.default_matmul_precision("highest"):
        _, inter = model.apply(params, jnp.asarray(f0), jnp.asarray(f1),
                               capture_intermediates=True)
    out = {}
    for li in range(model.num_blocks):
        raw = np.asarray(inter["intermediates"][f"fusion_dcn{li}"]
                         ["offset_conv"]["__call__"][0])
        o_s, m, o_d = np.split(raw, 3, axis=-1)
        out[f"offset_l{li}"] = np.concatenate([o_s, o_d], axis=-1)
        out[f"mask_l{li}"] = 1.0 / (1.0 + np.exp(-m))
    return out


def test_offset_planes_match_jax_capture_intermediates():
    """A tiny random model (mid 8, two blocks, R=2) whose offset convs,
    zero at init, are drawn at random so that the offsets are not."""
    f0, f1 = _tiny_pair()
    kw = dict(mid_channels=8, num_blocks=2, dcn_max_offset=2,
              warp_max_flow=16)
    jm = JEMAVFI(**kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(f0), jnp.asarray(f1)))
    rng = np.random.default_rng(4)
    for li in range(2):
        oc = params["params"][f"fusion_dcn{li}"]["offset_conv"]
        oc["kernel"] = rng.normal(0, 0.3, oc["kernel"].shape).astype(
            np.float32)
        oc["bias"] = rng.normal(0, 0.5, oc["bias"].shape).astype(np.float32)
    ref = _jax_planes(params, jm, f0, f1)
    model = EMAVFI(**kw)
    model.load_state_dict(params_from_jax(params))
    model.eval()
    got = dump_offsets.offset_planes(model, torch.from_numpy(f0),
                                     torch.from_numpy(f1))
    assert got.keys() == ref.keys()
    assert np.abs(ref["offset_l1"]).max() > 1.0
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], atol=PLANE_TOL,
                                   rtol=PLANE_TOL, err_msg=k)
    assert all(m.capture is None for m in (model.fusion_dcn0,
                                           model.fusion_dcn1))


def test_dump_offsets_writes_what_bench_kernels_reads(tmp_path, capsys):
    out = str(tmp_path / "planes.npz")
    res = dump_offsets.main(["--device", "cpu", "--smoke", "--ckpt",
                             os.path.join(REPO, "artifacts",
                                          "emavfi_qocc_best.npz"),
                             "--radius", "1", "--out", out])
    data = np.load(out)
    h, w = dump_offsets.SMOKE
    assert sorted(data.files) == sorted(
        [f"offset_l{i}" for i in range(3)] + [f"mask_l{i}" for i in range(3)])
    for k in data.files:
        width = 18 if k.startswith("offset") else 9
        assert data[k].dtype == np.float16 and data[k].shape == (1, h, w,
                                                                  width)
        np.testing.assert_array_equal(data[k],
                                      res["planes"][k].astype(np.float16))
    assert len(res["dx_p99"]) == 3 and json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])["out"] == out
    bench = bench_kernels.main(["--device", "cpu", "--smoke", "--offsets",
                                out, "--radius", "1", "--iters", "1"])
    assert {r["regime"] for r in bench["rows"]} == {"real:l0", "real:l1",
                                                    "real:l2"}


@pytest.mark.parametrize("R,th,wchunk", [(2, 8, 128), (1, 8, 64),
                                         (3, 4, 32)])
def test_pair_stats_is_the_jax_tools(R, th, wchunk):
    from tools.offset_stats import pair_stats as j_pair_stats

    rng = np.random.default_rng(R)
    dx = np.clip(rng.normal(0, 0.6, (48, 256, 9)), -R, R).astype(np.float32)
    assert offset_stats.pair_stats(dx, R, th, wchunk) == j_pair_stats(
        dx, R, th, wchunk)


@pytest.mark.parametrize("path", sorted(bench_train_step.PATHS))
def test_bench_train_step_config_is_the_yaml_file(path):
    """The tool's YAML values as overrides give what PyYAML reads from
    config/train_config.yaml under the same overrides."""
    args = bench_train_step.parse_args(["--device", "cpu", "--paths", path])
    ov = bench_train_step.overrides(args, path)
    want = load_train_config(os.path.join(REPO, "config",
                                          "train_config.yaml"), ov)
    assert bench_train_step.config(args, path) == want
    assert want.use_pallas == (path != "plain")
    assert want.conv_kernel == ("pallas" if path == "kernels+conv"
                                else "xla")
    yaml_only = load_train_config(None, bench_train_step.YAML_OVERRIDES)
    assert yaml_only == load_train_config(os.path.join(
        REPO, "config", "train_config.yaml"))


def test_bench_train_step_takes_the_jax_path_names():
    args = bench_train_step.parse_args(["--paths",
                                        "xla,pallas,pallas+conv,"
                                        "pallas_handbwd"])
    assert args.paths == ["plain", "kernels", "kernels+conv", "handbwd"]
    with pytest.raises(SystemExit):
        bench_train_step.parse_args(["--paths", "pallas_oldbwd"])


@pytest.mark.parametrize("flag", ["--dcn_kernel", "--tile_w"])
def test_profile_forward_refuses_the_tpu_knobs(flag, capsys):
    with pytest.raises(SystemExit, match="dcn_plan"):
        profile_forward.main(["--device", "cpu", "--smoke", flag, "4"])


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_profile_forward_smoke(capsys, tmp_path):
    res = profile_forward.main(["--device", "cpu", "--smoke", "--ckpt",
                                os.path.join(REPO, "artifacts",
                                             "emavfi_qocc_best.npz"),
                                "--radius", "1", "--conv_kernel", "pallas",
                                "--top", "5", "--keep", str(tmp_path)])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["frames"] \
        == res["frames"] == 1
    assert len(res["top_kernels_ms"]) == 5
    assert (tmp_path / "trace.json").stat().st_size > 0
    rows = (sum(res["timeline_ms"].values())
            - res["cross_category_overlap_ms"] + res["idle_ms"])
    assert rows == pytest.approx(res["trace_span_ms"])
    # the model's spans: printed, never counted as ops, their self ms
    # adding up to the outermost spans' inclusive ms
    spans = res["spans"]
    assert {"vfi.features", "vfi.fusion", "vfi.dcn",
            "vfi.reconstruct"} <= set(spans)
    assert "spans (ms;" in out and "vfi.reconstruct" in out
    assert not any(n.startswith("vfi.") for n, _ in res["top_kernels_ms"])
    assert sum(r["host_self_ms"] for r in spans.values()) == pytest.approx(
        res["span_roots_ms"])
    assert res["span_roots_ms"] == pytest.approx(sum(
        spans[n]["host_ms"] for n in ("vfi.features", "vfi.context",
                                      "vfi.motion", "vfi.warp", "vfi.fusion",
                                      "vfi.reconstruct")))


def test_offset_stats_smoke(capsys):
    res = offset_stats.main(["--device", "cpu", "--smoke"])
    assert _last_json(capsys) == res
    assert len(res["layers"]) == 3 and res["wchunk"] == 16
    for row in res["layers"]:
        assert 9 <= row["pairs_wchunk"] <= row["pairs_full_w"] <= 45


def test_bench_flowprior_smoke(capsys):
    res = bench_flowprior.main(["--device", "cpu", "--smoke"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip()
             .splitlines()[-2:]]
    assert [ln["mode"] for ln in lines] == ["plain", "flow_prior"]
    assert lines[1]["overhead_pct"] == pytest.approx(res["overhead_pct"])
    assert res["plain_fps"] > 0 and res["flow_prior_fps"] > 0


def test_bench_train_step_smoke(capsys, tmp_path):
    out = tmp_path / "steps.json"
    res = bench_train_step.main(["--device", "cpu", "--smoke", "--paths",
                                 "plain,kernels,kernels+conv,handbwd",
                                 "--json_out", str(out)])
    assert json.loads(out.read_text()) == _last_json(capsys)
    steps = res["results"]
    assert set(steps) == {"plain", "kernels", "kernels+conv", "handbwd"}
    # one forward function on every path: the first step's loss agrees
    first = {p: r["first_loss"] for p, r in steps.items()}
    assert first["handbwd"] == first["kernels"]
    assert all(np.isfinite(v) for v in first.values())
    cos = torch.nn.functional.cosine_similarity(
        res["grads"]["kernels"], res["grads"]["handbwd"], dim=0)
    assert cos > 0.9999


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__)
def test_tools_run_on_the_card_unless_asked_for_the_cpu(monkeypatch, tool,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--smoke"]
    if tool is dump_offsets:
        argv += ["--out", str(tmp_path / "x.npz")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
