"""`vfibench.counts` against counts by hand."""

import json

import pytest

from vfibench.counts import PEAK_BF16, PEAK_BYTES, bound_s
from vfibench.counts.conv import chain, conv
from vfibench.counts.dcn import dcn
from vfibench.counts.model import flops, ops
from vfibench.manifest import REPO


def test_conv_by_hand():
    # 3x3, 64 -> 128, stride 2 on 2 x 720 x 1280: 360 x 640 out
    c = conv(2, 720, 1280, 64, 128, k=3, stride=2)
    assert c["out"] == (360, 640)
    assert c["flops"] == 2 * 2 * 360 * 640 * 9 * 64 * 128
    assert c["bytes"] == 2 * (2 * 720 * 1280 * 64 + 9 * 64 * 128 + 128
                              + 2 * 360 * 640 * 128)
    one = conv(1, 10, 10, 67, 64, k=1)
    assert one["flops"] == 2 * 100 * 67 * 64 and one["out"] == (10, 10)


def test_chain_by_hand():
    # 128 -> 64 -> 64 -> 2 at 4 x 8 x 16: intermediates not counted
    c = chain(4, 8, 16, (128, 64, 64, 2))
    n = 4 * 8 * 16
    assert c["flops"] == 2 * n * 9 * (128 * 64 + 64 * 64 + 64 * 2)
    assert c["bytes"] == 2 * (n * (128 + 2) + 9 * (128 * 64 + 64 * 64
                                                   + 64 * 2) + 64 + 64 + 2)


def test_dcn_by_hand():
    d = dcn(1, 720, 1280, 64, 64)
    n = 720 * 1280
    assert d["flops"] == 2 * n * 9 * 64 * 64
    assert d["bytes"] == 2 * (n * (64 + 18 + 9 + 64) + 9 * 64 * 64 + 64)
    # chip_smoke.py's bound of this row: 0.0853 ms, bytes-bound
    assert bound_s(d["bytes"], d["flops"]) * 1e3 == pytest.approx(0.0853,
                                                                   abs=1e-4)
    assert d["bytes"] / PEAK_BYTES > d["flops"] / PEAK_BF16


@pytest.mark.parametrize("name", ["qocc", "q12"])
def test_model_ops(name):
    cfg = json.loads((REPO / "vfibench" / "configs" / f"{name}.json")
                     .read_text())
    w, e = cfg["widths"], cfg["engine"]
    one = ops(w, e, 1, 720, 1280)
    groups = [g for g, _, _ in one]
    assert groups.count("dcn") == 3
    # feat and motion chains at two cascade levels, 3 offset convs, rec
    assert groups.count("chain") == 2 * 2 + 3 + 1
    assert flops(w, e, 8, 720, 1280) == pytest.approx(
        8 * flops(w, e, 1, 720, 1280))
    assert 1.0e12 < flops(w, e, 1, 720, 1280) < 1.2e12
    fused = 64 if w["fuse_project"] else 67
    dcn0 = next(op for g, n, op in one if n == "dcn0")
    assert dcn0["flops"] == 2 * 720 * 1280 * 9 * fused * fused
