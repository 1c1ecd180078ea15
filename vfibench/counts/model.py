"""Every op of one served call: `b` frame pairs at (h, w) through the flow
prior, the self-cascade and EMAVFI, from the configuration's widths and
engine settings. Each op names its `group`:

- "chain": the stride-1 3x3 conv chains (feature blocks, motion,
  reconstruction) and each DCN's offset conv, a chain of one layer;
- "dcn": the deformable convs;
- "conv": the other convs (the first feature conv, the context convs,
  the 1x1 projection, the flow network's), and the context dense.

MFU counts the FLOPs of every op; the rooflines take the bound of one
group. Resizes, warps, normalisation and the uint8 conversion are not
counted: they are interpolation and elementwise work, not model FLOPs.
"""

from vfibench.counts.conv import chain, conv, out_size
from vfibench.counts.dcn import dcn


def _motion(b, h, w, c, m, nb, tag):
    """Feature extraction, context and motion at (h, w)."""
    ops = [("conv", f"{tag}feat_ext_conv1", conv(b, h, w, 2 * c, m))]
    ops.append(("chain", f"{tag}feat_chain", chain(b, h, w, (m,) * (nb + 1))))
    h2, w2 = out_size(h, 3, 2), out_size(w, 3, 2)
    h4, w4 = out_size(h2, 3, 2), out_size(w2, 3, 2)
    ops += [("conv", f"{tag}ctx_conv1", conv(b, h, w, m, 2 * m, stride=2)),
            ("conv", f"{tag}ctx_conv2", conv(b, h2, w2, 2 * m, 4 * m,
                                             stride=2)),
            ("conv", f"{tag}ctx_conv3", conv(b, h4, w4, 4 * m, 4 * m)),
            ("conv", f"{tag}ctx_dense", {
                "flops": 2.0 * b * 4 * m * m,
                "bytes": 2.0 * (b * 4 * m + 4 * m * m + m + b * m)}),
            ("chain", f"{tag}motion_chain",
             chain(b, h, w, (2 * m, m, m, 2)))]
    return ops


def ops(widths: dict, engine: dict, b: int, h: int, w: int) -> list:
    """[(group, name, {"flops", "bytes", ...}), ...] of one call."""
    c, m, nb = (widths["in_channels"], widths["mid_channels"],
                widths["num_blocks"])
    out = []
    fm = widths["flow_mid_channels"]
    for k in range(engine["flow_levels"] - 1, -1, -1):
        lh, lw = h >> k, w >> k
        for i, (ci, co) in enumerate(((2 * c + 2, fm), (fm, fm), (fm, 2))):
            out.append(("conv", f"flow_l{k}_conv{i}",
                        conv(b, lh, lw, ci, co)))
    for lvl in range(engine["cascade_levels"] - 1, 0, -1):
        s = 2 ** lvl
        out += _motion(b, -(-h // s), -(-w // s), c, m, nb, f"cascade{lvl}_")
    out += _motion(b, h, w, c, m, nb, "")
    fused = m + c
    if widths["fuse_project"]:
        out.append(("conv", "fuse_proj", conv(b, h, w, m + c, m, k=1)))
        fused = m
    for i in range(nb):
        out.append(("chain", f"dcn{i}_offset", chain(b, h, w, (fused, 27))))
        out.append(("dcn", f"dcn{i}", dcn(b, h, w, fused, fused)))
    out.append(("chain", "rec_chain",
                chain(b, h, w, (fused, m, m // 2, c))))
    return out


def flops(widths: dict, engine: dict, b: int, h: int, w: int) -> float:
    return sum(op["flops"] for _, _, op in ops(widths, engine, b, h, w))
