"""The control of the correctness check: the plain reference put in the
program's place, computed one precision step below the configuration's
bfloat16 (float8 e4m3 operands, `Reference(precision="fp8")`), and
judged as a run judges the program: the worst share of pixel values more
than 2 uint8 levels from the float32 reference (`check.off2_pct`) over
the cell's pool of pairs at the cell's own size. It has to read above
the cell's `off2_pct` limit.

    python3 -m vfibench.control --workload <cell> --seeds 11 12 13

prints one JSON line a seed. Benchmark runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import time

from vfibench.check import off2_pct, reference_midpoints, rms_levels
from vfibench.inputs import make_pool
from vfibench.manifest import load_cell


def reading(cell: dict, seed: int, device: str) -> dict:
    p = cell["params"]
    pool = make_pool(seed, p["pool"], tuple(p["size"]), tuple(p["crop"]))
    pairs = list(range(p["pool"]))
    t = time.perf_counter()
    ref = reference_midpoints(cell["config_spec"], pool, pairs, device)
    t_ref = time.perf_counter() - t
    ctl = reference_midpoints(cell["config_spec"], pool, pairs, device,
                              precision="fp8")
    off = [off2_pct(ctl[i], ref[i]) for i in pairs]
    rms = [rms_levels(ctl[i], ref[i]) for i in pairs]
    return {"workload": cell["name"], "seed": seed, "off2_pct": max(off),
            "off2_pct_min": min(off), "limit": cell["check"]["off2_pct"],
            "rms_levels": max(rms), "rms_levels_min": min(rms),
            "reference_s": t_ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    for seed in a.seeds:
        print(json.dumps(reading(cell, seed, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
