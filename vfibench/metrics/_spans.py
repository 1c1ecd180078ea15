"""Shared by the readers of the program's engine spans: the `vfi.*` host
spans that `vfi_tpu_torch` records under a profiler (`vfi.midpoints` a
call, `vfi.launch` a guard chunk, `vfi.upload` a copy in, `vfi.forward`
the model and prior), in the traced slice's host ops. A slice with no
`vfi.*` span (a program without them) gives nothing to read."""

from vfibench.trace import gaps, union_s

PREFIX = "vfi."


def has_spans(tr) -> bool:
    return any(n.startswith(PREFIX) for _, _, n in tr.host)


def intervals(tr, name: str, whole: bool = False) -> list:
    """(start_us, end_us) of the spans `name` in the slice; with `whole`,
    only those that lie wholly inside it (the host ops are clipped to the
    slice)."""
    return [(s, e) for s, e, n in tr.host if n == name
            and (not whole or (s > tr.t0 and e < tr.t1))]


def overlap_s(a: list, b: list) -> float:
    """Seconds covered by both sets of intervals: |A| + |B| - |A u B|."""
    return union_s(a) + union_s(b) - union_s(a + b)


def idle_pct_in(tr, name: str):
    """100 x the seconds of the slice in which no kernel runs (the gaps
    `device_idle_pct` counts) inside the spans `name`, over the slice's
    length; None without spans."""
    if tr.window_s <= 0.0 or not has_spans(tr):
        return None
    iv = intervals(tr, name)
    if not iv:
        return None
    idle = gaps([(s, e) for s, e, _ in tr.kernels()], tr.t0, tr.t1)
    return 100.0 * overlap_s(iv, idle) / tr.window_s
