"""Profiling and step timing, the port of `vfi_tpu/utils/profiling.py`.

`trace(log_dir)` captures a `torch.profiler` trace of the block (the CPU,
and the CUDA device where there is one) and writes it as a Chrome trace,
`log_dir/trace.json` (readable by Perfetto and chrome://tracing).
`StepTimer` keeps the reference's named sections and percentile report; it
synchronises the device it names before it reads the clock, so a section's
time includes the device work queued inside it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

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
