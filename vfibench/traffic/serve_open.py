"""Open-loop serving traffic: independent clients send raw-route frame
pairs to the HTTP server at Poisson arrivals of a fixed rate.

This process builds the engine and `serve.InterpolationServer` around it
(127.0.0.1, a free port, the cell's batcher settings) and warms the
frame size's bucket; the client is a child process (`vfibench.openloop`)
that makes the same seeded pool and sends request k at its due time.
Each request is timed by the client from when it was due to the end of
its response. The engine reaches the server through `EngineProxy`, which
records a span around each `midpoints` call and its copy to the host.

`latency_p95_ms` / `latency_p50_ms`: percentiles (linear interpolation)
of every request due in the window; a request that failed or never came
counts as the longest wait the client gave it. With `trace`, the profiler
records `slice_s` seconds from `slice_at` of the window.

Parameters: size, crop, pool, rate, senders, drain_s, slice_at,
slice_s, max_batch, max_delay_ms, pad_to_max, max_px_per_launch.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from vfibench.inputs import make_pool
from vfibench.manifest import REPO


class EngineProxy:
    """The engine as the server sees it, with a span around each call."""

    def __init__(self, engine):
        from torch.profiler import record_function

        self.engine = engine
        self.io_dtype = engine.io_dtype
        self.device = engine.device
        self.spans: list = []
        self._rf = record_function

    def midpoints(self, f0, f1):
        t = time.perf_counter()
        with self._rf("vfibench.engine_call"):
            out = self.engine.midpoints(f0, f1).cpu().numpy()
        self.spans.append((t, time.perf_counter()))
        return out

    def busy_s(self, lo: float, hi: float) -> float:
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.spans)


def client_command(seed: int, p: dict, seconds: float) -> list:
    return [sys.executable, "-m", "vfibench.openloop", "--seed", str(seed),
            "--rate", str(p["rate"]), "--seconds", str(seconds),
            "--size", *map(str, p["size"]), "--crop", *map(str, p["crop"]),
            "--pool", str(p["pool"]), "--senders", str(p["senders"]),
            "--drain", str(p["drain_s"])]


def read_client(proc) -> dict:
    """The client's JSON line and its sampled responses."""
    head = proc.stdout.readline()
    if not head:
        raise RuntimeError(f"the client ended without a result "
                           f"(code {proc.wait()})")
    res = json.loads(head)
    res["kept"] = {k: (pair, proc.stdout.read(nb))
                   for k, pair, nb in res["samples"]}
    return res


def latencies_ms(res: dict, drain_s: float) -> np.ndarray:
    """Each request's latency; a failed one counts as the longest wait the
    client gave it (its drain)."""
    return np.array([1e3 * (v if v is not None else drain_s)
                     for v in res["latency_s"]])


def start_client(seed: int, p: dict, seconds: float):
    return subprocess.Popen(client_command(seed, p, seconds), cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)


def stop_client(client) -> None:
    if client.stdin and not client.stdin.closed:
        client.stdin.close()
    try:
        client.wait(timeout=30)
    except subprocess.TimeoutExpired:
        client.kill()
        client.wait()


def window(server, engine: EngineProxy, client, p: dict, seconds: float,
           tracer=None) -> tuple:
    """One open-loop window against a started server: (the client's
    result, the serving counters over the window). `tracer` (a
    `trace.Slice`) profiles `slice_s` from `slice_at` of the window."""
    if client.stdout.readline() != b"ready\n":
        raise RuntimeError("the client did not start")
    stats = server.batcher.stats
    req0, bat0 = stats.requests, stats.batches
    t_go = time.perf_counter()
    client.stdin.write(f"go {server.port}\n".encode())
    client.stdin.flush()
    if tracer is not None:
        time.sleep(max(0.0, t_go + p["slice_at"] * seconds
                       - time.perf_counter()))
        tracer.start()
        time.sleep(p["slice_s"])
        tracer.stop()
    res = read_client(client)
    t_end = time.perf_counter()
    print(f"client: {res['n']} requests over {res['span_s']:.3f} s, "
          f"{sum(1 for s in res['status'] if s != 200)} failed, "
          f"{res['sends_waited']} sends waited for a sender, send late "
          f"max {1e3 * max(res['late_send_s']):.3f} ms", file=sys.stderr)
    return res, {"requests": stats.requests - req0,
                 "batches": stats.batches - bat0,
                 "worker_busy_s": engine.busy_s(t_go, t_end),
                 "window_s": t_end - t_go}


def run(ctx: dict) -> dict:
    import torch

    from vfibench.program import build_engine, build_server
    from vfibench.trace import Slice

    p, seconds, dev = ctx["params"], ctx["seconds"], ctx["device"]
    size = tuple(p["size"])
    t_imp = time.perf_counter()
    client = start_client(ctx["seed"], p, seconds)
    server = None
    try:
        pool = make_pool(ctx["seed"], p["pool"], size, tuple(p["crop"]))
        t_pool = time.perf_counter()
        engine = EngineProxy(build_engine(ctx["config"], dev))
        t_engine = time.perf_counter()
        server = build_server(engine, p)
        server.warmup([size])
        server.start()
        cuda = torch.device(dev).type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
        t_warm = time.perf_counter()
        if client.stdout.peek(1) == b"":
            raise RuntimeError("the client ended before it was ready")
        setup_s = time.perf_counter() - ctx["t0"]
        print(f"set-up {setup_s:.3f} s: start and imports "
              f"{t_imp - ctx['t0']:.3f}, pool {t_pool - t_imp:.3f}, engine "
              f"{t_engine - t_pool:.3f}, server and warm-up "
              f"{t_warm - t_engine:.3f}, client "
              f"{ctx['t0'] + setup_s - t_warm:.3f}", file=sys.stderr)
        tracer = Slice(dev) if ctx["trace"] else None
        res, serve = window(server, engine, client, p, seconds, tracer)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    finally:
        if server is not None:
            server.shutdown()
        stop_client(client)
    lat = latencies_ms(res, p["drain_s"])
    h, w = size
    samples = [(pair, np.frombuffer(data, np.uint8).reshape(h, w, 3))
               for pair, data in res["kept"].values()
               if len(data) == h * w * 3]
    trace_ctx = None
    if tracer is not None:
        trace_ctx = {"trace": tracer.reduce(), "serve": serve, "size": size,
                     "config": ctx["config"]}

    def release():
        nonlocal engine, server
        engine = server = None

    return {"e2e": {"latency_p95_ms": float(np.percentile(lat, 95)),
                    "latency_p50_ms": float(np.percentile(lat, 50)),
                    "setup_s": setup_s},
            "attempted": res["n"],
            "failed": sum(1 for s in res["status"] if s != 200),
            "samples": samples, "pool": pool, "memory_peak_bytes": peak,
            "trace_ctx": trace_ctx, "release": release}
