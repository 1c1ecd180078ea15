"""The traced slice of a run: `torch.profiler` over a steady stretch of
the window, reduced to device ops and host ops on one clock.

`Slice.start()` / `stop()` bracket the stretch; both synchronise the
card, and the stretch is marked by a host span of its own
(`vfibench.slice`), whose interval is the traced window. `reduce()`, run
after the window has closed, keeps the device ops (kernels, copies,
memsets; not the host spans the profiler mirrors on the device's
timeline) and the host ops that overlap it. The idle arithmetic (interval
unions) is that of the program's `utils/profiling.timeline`, copied.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

SPAN_PREFIX = "vfibench."     # the benchmark's own host spans
SPAN = SPAN_PREFIX + "slice"
# Device ops that are not kernels, by name.
_NOT_KERNEL = re.compile(r"^(Memcpy|Memset)|\bmemcpy|\bmemset", re.I)


def union_s(iv) -> float:
    """Covered seconds of (start_us, end_us) intervals."""
    out, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                out += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        out += cur_e - cur_s
    return out / 1e6


def gaps(iv, lo: float, hi: float) -> list:
    """(start_us, end_us) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(iv):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Reduced:
    """The traced window [t0, t1] (us) and what ran in it."""
    t0: float
    t1: float
    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self, pattern: re.Pattern | None = None) -> list:
        return [(s, e, n) for s, e, n in self.device
                if not _NOT_KERNEL.search(n)
                and (pattern is None or pattern.search(n))]

    def busy_s(self, ops=None) -> float:
        return union_s([(s, e) for s, e, _ in
                        (self.device if ops is None else ops)])

    def kernel_s(self, pattern: re.Pattern) -> float:
        """Summed device seconds of the kernels whose names match."""
        return sum(e - s for s, e, _ in self.kernels(pattern)) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """Idle gaps of the device (no op at all), summed by the innermost
        host op running at each gap's midpoint; gaps under 2 us are
        summed apart."""
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        by = {}
        for a, b in gaps([(s, e) for s, e, _ in self.device],
                         self.t0, self.t1):
            if b - a < 2.0:
                label = "gaps under 2 us"
            else:
                t = (a + b) / 2
                label, best = "no host op recorded", None
                i = bisect.bisect_right(starts, t)
                for s, e, name in reversed(host[max(0, i - 400):i]):
                    if e >= t and (best is None or s > best):
                        label, best = name, s
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Slice:
    """One profiled stretch of the window."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.prof = None
        self._span = None
        self.on = self.done = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._span = record_function(SPAN)
        self._span.__enter__()
        self.on = True

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.on, self.done = False, True

    def reduce(self) -> Reduced:
        kind = self.torch.autograd.DeviceType
        evs = self.prof.events()
        span = [e for e in evs if e.name == SPAN and e.device_type == kind.CPU]
        if not span:
            raise RuntimeError("the traced slice recorded no span")
        t0, t1 = span[0].time_range.start, span[0].time_range.end
        out = Reduced(t0, t1)
        for e in evs:
            a, b = e.time_range.start, e.time_range.end
            if b <= a or b <= t0 or a >= t1 or e.name == SPAN:
                continue
            a, b = max(a, t0), min(b, t1)
            if e.device_type == kind.CUDA:
                # a host span mirrored on the device's timeline is no op
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN_PREFIX)):
                    out.device.append((a, b, e.name))
            elif e.device_type == kind.CPU:
                out.host.append((a, b, e.name))
        self.prof = None
        return out
