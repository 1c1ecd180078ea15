"""Profiling and step timing, the port of `vfi_tpu/utils/profiling.py`.

`trace(log_dir)` captures a `torch.profiler` trace of the block (the CPU,
and the CUDA device where there is one) and writes it as a Chrome trace,
`log_dir/trace.json` (readable by Perfetto and chrome://tracing).
`StepTimer` keeps the reference's named sections and percentile report; it
synchronises the device it names before it reads the clock, so a section's
time includes the device work queued inside it.

`device_profile(fn)` runs `fn` under torch.profiler and breaks its device
time down as the JAX package's `tools/profile_forward.py` does: by kernel
name, by category (`category`: the port's kernels, cuDNN convolution,
gemm, elementwise, reduce, layout, collectives, other) summed, and on the
timeline (`timeline`: the union of each category's intervals, the
overlap between categories and the device's idle gaps, which together
make the trace's wall span). `PORT_KERNELS` names the port's CUDA kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# The port's CUDA kernels, as their names appear in a trace (csrc/*.cu).
PORT_KERNELS = ("conv_chain_kernel", "conv2d_kernel", "conv2d_f32_kernel",
                "dcn_tile_kernel", "dcn_stream_kernel", "dcn_tile_f32_kernel",
                "dcn_stream_f32_kernel", "warp_bounded_kernel",
                "warp_bounded_wide_kernel", "warp_bounded_wide_2b_kernel")
CATEGORIES = ("port-kernels", "convolution", "gemm", "elementwise",
              "reduce", "layout", "collectives", "other")
# Lower-case name fragments of each category but the port's kernels, tried
# in this order (a cuDNN convolution's name may hold "gemm", a copy's
# "elementwise"). On the CPU the ops are aten's: `aten::conv2d`,
# `aten::matmul`, `aten::copy_`.
_FRAGMENTS = (
    ("collectives", ("nccl",)),
    ("layout", ("memcpy", "memset", "copy", "transpose", "nchwtonhwc",
                "nhwctonchw", "permute", "::cat")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                     "winograd")),
    ("gemm", ("gemm", "gemv", "cutlass", "cublas", "matmul", "::mm",
              "addmm", "bmm")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def category(name: str) -> str:
    """The category of a device op (a kernel, memcpy or memset) by its
    name: one of CATEGORIES."""
    if any(k in name for k in PORT_KERNELS):
        return "port-kernels"
    low = name.lower()
    for cat, frags in _FRAGMENTS:
        if any(f in low for f in frags):
            return cat
    return "other"


def union_ms(iv: Sequence[Tuple[float, float]]) -> float:
    """Total covered time (ms) of (start_us, end_us) intervals; the
    counterpart of the JAX tool's `_union_ms` over picoseconds."""
    out = 0.0
    cur_s = cur_e = None
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                out += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        out += cur_e - cur_s
    return out / 1e3


def timeline(events: Sequence[Tuple[float, float, str]]) -> tuple:
    """(by_cat, busy, wall) in ms of (start_us, end_us, category) events:
    each category's busy time as an interval union (queued or overlapping
    ops are not counted twice), the union of all, and the wall span from
    the first start to the last end. sum(by_cat) - busy is the overlap
    between categories and wall - busy the idle gaps, so the rows, less
    the overlap, plus the gaps make the wall."""
    if not events:
        return {}, 0.0, 0.0
    wall = (max(e for _, e, _ in events) - min(s for s, _, _ in events)) / 1e3
    busy = union_ms([(s, e) for s, e, _ in events])
    by_cat = {c: union_ms([(s, e) for s, e, cc in events if cc == c])
              for c in sorted({c for _, _, c in events})}
    return by_cat, busy, wall


def device_profile(fn: Callable[[], object], device=None,
                   log_dir: Optional[str] = None, top: int = 12) -> dict:
    """Run `fn` once under torch.profiler and break down its device time.

    `device`: a CUDA device (None: "cuda"), whose kernels, memcpys and
    memsets are the device ops; or the CPU, whose outermost aten ops are
    (an op's nested calls are its own time). The
    block ends with a synchronise of the device. `log_dir`: also write the
    Chrome trace there (`trace`). Returns the host wall of the block
    (`wall_ms`), the trace's device span, busy time and idle gaps, the
    busy share of the host wall, device ms summed by category and by name
    (the `top` names), the timeline view (`timeline`), the port's kernels'
    and the other ops' ms, and the count of device ops."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    ctx = (trace(log_dir) if log_dir else profile(
        activities=[ProfilerActivity.CPU]
        + ([ProfilerActivity.CUDA] if cuda else [])))
    with ctx as prof:
        w0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - w0) * 1e3
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    events, by_name = [], {}
    for ev in prof.events():
        nested = not cuda and ev.cpu_parent is not None
        if ev.device_type != kind or nested:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        if b <= a:
            continue
        events.append((a, b, category(ev.name)))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) / 1e3
    if not events:
        raise RuntimeError(f"the profiler recorded no op on {dev}")
    by_cat = {c: 0.0 for c in CATEGORIES}
    for name, ms in by_name.items():
        by_cat[category(name)] += ms
    union, busy, span = timeline(events)
    total = sum(by_name.values())
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device": str(dev), "wall_ms": wall_ms,
            "trace_span_ms": span, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "idle_ms": span - busy, "idle_share": (span - busy) / span,
            "device_kernel_ms": total,
            "port_kernels_ms": by_cat["port-kernels"],
            "other_kernels_ms": total - by_cat["port-kernels"],
            "kernel_launches": len(events), "n_kernel_names": len(by_name),
            "category_ms": by_cat, "timeline_ms": union,
            "cross_category_overlap_ms": sum(union.values()) - busy,
            "top_kernels_ms": [[k[:90], v] for k, v in top_ops]}


@dataclass
class StepTimer:
    """Wall-clock step timer with named sections and a percentile report.

    `device` names the device to synchronise before each clock read (a
    CUDA device, or None / the CPU for none).

    Usage:
        timer = StepTimer(device="cuda")
        with timer.section("data"):
            batch = next(it)
        with timer.section("step"):
            out = engine.midpoints(f0, f1)
        print(timer.report())
    """

    device: Optional[torch.device] = None
    sections: Dict[str, List[float]] = field(default_factory=dict)

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self, last_n: int = 100) -> str:
        lines = []
        for name, vals in self.sections.items():
            v = np.asarray(vals[-last_n:]) * 1000.0
            lines.append(
                f"{name}: p50 {np.percentile(v, 50):.1f} ms  "
                f"p90 {np.percentile(v, 90):.1f} ms  "
                f"mean {v.mean():.1f} ms  n={len(vals)}")
        return "\n".join(lines)

    def mean(self, name: str) -> float:
        return float(np.mean(self.sections.get(name, [float('nan')])))
