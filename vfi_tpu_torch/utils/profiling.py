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
`port_kernel_counts(events)` counts the port's kernels by name among a
profile's device events, those a CUDA graph replays included.

`span(name)` opens one of the program's named host spans (`vfi.*`): a
`torch.profiler.record_function` while a profiler records, so the spans
sit in the profiler's own event list, on the clock of its device trace,
and the kernels launched inside one link to it through the profiler's
correlation; with no profiler running, one shared no-op context. The
spans reach whatever exports the profile (`trace`, the trainer's
`profile_dir`) and `device_profile`'s span table.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import re
import time
from collections import Counter
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


SPAN_PREFIX = "vfi."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The program's host span `name` (`vfi.*`): `record_function(name)`
    while a profiler records, else one shared no-op context. A span with
    no profiler running costs under a microsecond; an unguarded
    `record_function` costs ~13 us an enter and exit on a CPU core even
    then."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


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


# A port kernel's name (csrc/*.cu's `__global__`s) inside the name a
# device trace gives it ("void dcn_tile_kernel<64, 16>(DcnParams)").
_PORT_KERNEL = re.compile(
    r"\b(conv2d(?:_f32)?|conv_chain(?:_f32)?|dcn_\w+?|warp_bounded\w*?)"
    r"_kernel\b")


def port_kernel_counts(events) -> Counter:
    """How often each of the port's CUDA kernels ran among a profile's
    device events (`torch.profiler.profile(...).events()`), by kernel
    name. CUPTI lists a CUDA graph's replayed kernels one by one, so this
    counts them where the wrappers' counters, which count at launch,
    cannot."""
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(m.group(0) for ev in events if ev.device_type == cuda
                   for m in [_PORT_KERNEL.search(ev.name)] if m)


def _merged(iv) -> list:
    """(start, end) intervals merged into disjoint sorted ones."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_ms(iv: Sequence[Tuple[float, float]]) -> float:
    """Total covered time (ms) of (start_us, end_us) intervals; the
    counterpart of the JAX tool's `_union_ms` over picoseconds."""
    return sum(e - s for s, e in _merged(iv)) / 1e3


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


# Device ops that are copies or memsets, not kernels, by name.
_NOT_KERNEL = re.compile(r"^(Memcpy|Memset)|\bmemcpy|\bmemset", re.I)


def _is_annotation(ev) -> bool:
    """A `record_function` span, on the host or mirrored on the device's
    timeline (no op of either)."""
    return (bool(getattr(ev, "is_user_annotation", False))
            or ev.name.startswith(SPAN_PREFIX))


def _below_spans_only(ev) -> bool:
    """No op encloses the host event `ev`: its ancestors are spans."""
    p = ev.cpu_parent
    while p is not None:
        if not _is_annotation(p):
            return False
        p = p.cpu_parent
    return True


def span_table(events, ops, cuda: bool) -> dict:
    """The `vfi.*` spans of a profile: `events`, the profiler's events;
    `ops`, the device ops `device_profile` counts.

    A device op belongs to the innermost span around the host call that
    launched it: on the card the runtime call (`cudaLaunchKernel`,
    `cuLaunchKernel`, `cudaMemcpyAsync`, ...) that shares the op's
    correlation id, placed by its start on the spans' clock (the port's
    ctypes launches link so too); on the CPU the op's own enclosing span.
    Spans of one name do not nest in the program. Returns `spans`, a row a
    name in order of first start: `count`; host ms inclusive (`host_ms`)
    and less the child spans (`host_self_ms`); the device ms and count of
    the ops launched inside the span and its descendants (`device_ms`,
    `ops`) and inside it alone (`device_self_ms`, `ops_self`); `idle_ms`,
    the time inside it in which no kernel ran (copies and memsets are
    idle). Besides: `span_roots_ms`, the host ms of the outermost spans
    (the self ms add up to it); `span_unattributed_ms`, the device ms of
    ops launched outside every span; `ops_before_span`, the ops that
    started before the span they belong to (0 on one clock)."""
    cpu_t = torch.autograd.DeviceType.CPU
    spans = sorted((ev for ev in events if ev.device_type == cpu_t
                    and ev.name.startswith(SPAN_PREFIX)),
                   key=lambda ev: (ev.time_range.start, -ev.time_range.end))
    idx = {id(ev): i for i, ev in enumerate(spans)}

    def enclosing(ev):
        p = ev.cpu_parent
        while p is not None and id(p) not in idx:
            p = p.cpu_parent
        return None if p is None else idx[id(p)]

    starts = [sp.time_range.start for sp in spans]

    def around(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i].time_range.end < t:
            i -= 1
        return None if i < 0 else i

    launch = {ev.id: ev for ev in events if ev.device_type == cpu_t
              and ev.name.startswith("cu") and not _is_annotation(ev)}
    n = len(spans)
    parent = [enclosing(sp) for sp in spans]
    dur = [(sp.time_range.end - sp.time_range.start) / 1e3 for sp in spans]
    dev_self, ops_self = [0.0] * n, [0] * n
    unattributed, early = 0.0, 0
    for op in ops:
        if cuda:
            call = launch.get(op.id)
            i = None if call is None else around(call.time_range.start)
        else:
            i = enclosing(op)
        ms = (op.time_range.end - op.time_range.start) / 1e3
        if i is None:
            unattributed += ms
            continue
        dev_self[i] += ms
        ops_self[i] += 1
        early += op.time_range.start < spans[i].time_range.start
    dev_in, ops_in, child_ms = list(dev_self), list(ops_self), [0.0] * n
    for i in range(n - 1, -1, -1):       # children sort after parents
        if parent[i] is not None:
            dev_in[parent[i]] += dev_in[i]
            ops_in[parent[i]] += ops_in[i]
            child_ms[parent[i]] += dur[i]
    busy = _merged([(op.time_range.start, op.time_range.end) for op in ops
                    if not (cuda and _NOT_KERNEL.search(op.name))])
    bstarts = [a for a, _ in busy]
    rows = {}
    for i, sp in enumerate(spans):
        s, e = sp.time_range.start, sp.time_range.end
        j, covered = max(0, bisect.bisect_right(bstarts, s) - 1), 0.0
        while j < len(busy) and busy[j][0] < e:
            covered += max(0.0, min(busy[j][1], e) - max(busy[j][0], s))
            j += 1
        r = rows.setdefault(sp.name, dict.fromkeys(
            ("count", "host_ms", "host_self_ms", "device_ms",
             "device_self_ms", "ops", "ops_self", "idle_ms"), 0))
        r["count"] += 1
        r["host_ms"] += dur[i]
        r["host_self_ms"] += dur[i] - child_ms[i]
        r["device_ms"] += dev_in[i]
        r["device_self_ms"] += dev_self[i]
        r["ops"] += ops_in[i]
        r["ops_self"] += ops_self[i]
        r["idle_ms"] += (e - s - covered) / 1e3
    return {"spans": rows,
            "span_roots_ms": sum(d for d, p in zip(dur, parent) if p is None),
            "span_unattributed_ms": unattributed, "ops_before_span": early}


def device_profile(fn: Callable[[], object], device=None,
                   log_dir: Optional[str] = None, top: int = 12) -> dict:
    """Run `fn` once under torch.profiler and break down its device time.

    `device`: a CUDA device (None: "cuda"), whose kernels, memcpys and
    memsets are the device ops; or the CPU, whose outermost aten ops below
    the spans are (an op's nested calls are its own time). Spans are no
    ops: neither the host's `record_function` spans nor their mirrors on
    the device's timeline. The block ends with a synchronise of the
    device. `log_dir`: also write the Chrome trace there (`trace`).
    Returns the host wall of the block (`wall_ms`), the trace's device
    span, busy time and idle gaps, the busy share of the host wall, device
    ms summed by category and by name (the `top` names), the timeline view
    (`timeline`), the port's kernels' and the other ops' ms, the count of
    device ops, and the program's span table (`span_table`)."""
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
    evs = list(prof.events())
    ops, events, by_name = [], [], {}
    for ev in evs:
        if (ev.device_type != kind or _is_annotation(ev)
                or (not cuda and not _below_spans_only(ev))):
            continue
        a, b = ev.time_range.start, ev.time_range.end
        if b <= a:
            continue
        ops.append(ev)
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
            "top_kernels_ms": [[k[:90], v] for k, v in top_ops],
            **span_table(evs, ops, cuda)}


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
