"""The rate sweep that places a serving cell's fixed rate: one engine and
server, then one open-loop window a rate, in increasing order.

    python3 -m vfibench.sweep --workload <cell> --seed N --seconds S
        --rates 16 20 24 ...

prints one JSON line a rate: offered and completed requests/s, latency
p50 / p95 / p99, the median latency of the window's first and last
quarter of requests (a backlog that grows makes the last far longer),
failures, the mean batch and the worker's busy share. The knee is the
highest rate whose completed rate keeps up with the offered one and whose
last quarter waits no longer than its first; the cell runs at 0.8 of it.
Benchmark runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from vfibench.manifest import load_cell, load_driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    import torch

    from vfibench.program import build_engine, build_server

    cell = load_cell(a.workload)
    drv = load_driver(cell["kind"])
    p = dict(cell["params"])
    card = (torch.cuda.get_device_name(a.device)
            if torch.device(a.device).type == "cuda" else "cpu")
    engine = drv.EngineProxy(build_engine(cell["config_spec"], a.device))
    server = build_server(engine, p)
    server.warmup([tuple(p["size"])])
    server.start()
    try:
        for rate in a.rates:
            p["rate"] = rate
            client = drv.start_client(a.seed, p, a.seconds)
            try:
                res, serve = drv.window(server, engine, client, p,
                                        a.seconds)
            finally:
                drv.stop_client(client)
            lat = drv.latencies_ms(res, p["drain_s"])
            q = max(1, len(lat) // 4)
            done = [v for v in res["latency_s"] if v is not None]
            print(json.dumps({
                "rate": rate, "n": res["n"],
                "completed_per_s": len(done) / res["span_s"],
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "first_quarter_p50_ms": float(np.median(lat[:q])),
                "last_quarter_p50_ms": float(np.median(lat[-q:])),
                "failed": sum(1 for s in res["status"] if s != 200),
                "batch_mean": serve["requests"] / max(1, serve["batches"]),
                "worker_busy_pct": 100 * serve["worker_busy_s"]
                / serve["window_s"],
                "card": card}), flush=True)
            time.sleep(1.0)
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
