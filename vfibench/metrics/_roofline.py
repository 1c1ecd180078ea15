"""Shared arithmetic of the `<kernel>_roofline_pct` readers: the least
time of one group of ops (`counts.model`) over every call of the traced
slice, over the device seconds of the kernels that computed them, matched
by name in the trace."""

from vfibench.counts import bound_s
from vfibench.counts.model import ops


def share(ctx, group: str, pattern):
    t = ctx["trace"].kernel_s(pattern)
    if not ctx.get("calls") or t <= 0.0:
        return None
    cfg = ctx["config"]
    h, w = ctx["size"]
    least = sum(bound_s(op["bytes"], op["flops"])
                for b in ctx["calls"]
                for g, _, op in ops(cfg["widths"], cfg["engine"], b, h, w)
                if g == group)
    return 100.0 * least / t
