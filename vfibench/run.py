"""One run of one benchmark cell:

    python3 -m vfibench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the repository root, on a machine with the cell's cards. It loads the
cell (`manifest`), makes the inputs from the seed, builds and warms the
program (set-up), measures for `--seconds` through the cell's traffic
driver, frees the program, compares the sampled answers with the plain
reference (`check`), and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with
`--trace 1` a `breakdown`, and last `checks`, each compared number beside
its limit (also the last lines on standard error).

Exits non-zero with no result where there is no CUDA card, fewer cards
than the cell asks for, a file of the cell missing, or JAX, Flax or the
JAX package `vfi_tpu` loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from vfibench.manifest import REPO  # noqa: E402

# Fixed cache directories inside the checkout: every run after the first
# finds what the first built.
CACHES = {"TORCH_EXTENSIONS_DIR": REPO / "build" / "vfibench" / "torch_extensions",
          "TRITON_CACHE_DIR": REPO / "build" / "vfibench" / "triton"}
FORBIDDEN = ("jax", "jaxlib", "flax", "vfi_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole: `vfi_tpu_torch` is not `vfi_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float) -> dict:
    """Drive the cell, read its metrics, judge its answers; the result as
    printed, without the JAX check."""
    import torch

    from vfibench import check
    from vfibench.manifest import load_driver, load_metric

    driver = load_driver(cell["kind"])
    m = driver.run({"params": cell["params"], "config": cell["config_spec"],
                    "seed": seed, "seconds": seconds, "trace": trace,
                    "device": device, "t0": t0})
    metrics = {}
    if trace:
        for spec in cell["per_layer"]:
            v = load_metric(spec).read(m["trace_ctx"])
            if v is not None:
                metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    else:
        for spec in cell["end_to_end"]:
            metrics[spec["name"]] = {"value": m["e2e"][spec["name"]],
                                     "unit": spec["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": m["memory_peak_bytes"]}
    out = {"correct": False, "attempted": m["attempted"],
           "failed": m["failed"], "metrics": metrics, "device": dev}
    if trace:
        tr = m["trace_ctx"]["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_by_host()}
    samples, pool, failed = m["samples"], m["pool"], m["failed"]
    m["release"]()
    m = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check.judge(cell, samples, failed, pool, device)
    out["correct"] = check.correct(checks)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, path in CACHES.items():
        os.environ[var] = str(path)
    from vfibench.manifest import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("vfibench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"vfibench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T0)
    bad = forbidden_modules()
    if bad:
        print(f"vfibench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    from vfibench.check import print_checks

    print(json.dumps(out), flush=True)
    print_checks(out["checks"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
