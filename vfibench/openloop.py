"""Open-loop HTTP client of the serving cells, run as its own process:

    python3 -m vfibench.openloop --seed N --rate R --seconds S --size H W
        --crop h w --pool P --senders K --drain D

It makes the seed's pool of pairs (`inputs.make_pool`, the server's
process makes the same), encodes each pair as a raw-route body
(`application/x-vfi-raw`: u16 H, u16 W, two packed RGB frames), prints
"ready" and waits for "go <port>" on standard input. Then it sends
request k at its due time (`schedule`) from a pool of `senders` threads,
so no send waits for a reply, and times each request from its due time to
the end of its response. When every request has been answered, or `drain`
seconds after the last due time, it writes one JSON line (per request:
latency, status, pair, how late its send started; the sample's indices)
and then the sampled responses' bytes, in that order, to standard output.

Imports numpy and OpenCV, not torch.
"""

from __future__ import annotations

import argparse
import http.client
import json
import queue
import struct
import sys
import threading
import time

import numpy as np

RAW_CONTENT_TYPE = "application/x-vfi-raw"
PATH = "/v1/interpolate"


def schedule(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the start) of round(rate * seconds) requests with
    Poisson-like arrivals: the exponential distribution's quantiles at
    (i + 0.5) / n as the gaps, shuffled by the seed and scaled so that
    they sum to `seconds`. Every seed sends the same number of requests
    with the same gaps, in another order."""
    n = int(round(rate * seconds))
    if n < 1:
        raise ValueError(f"rate {rate} over {seconds} s sends nothing")
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = np.random.default_rng([seed, 2]).permutation(gaps)
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def pairs_of(seed: int, n: int, pool: int) -> np.ndarray:
    """The pool pair each request sends: the pool in a seeded order,
    cycled."""
    order = np.random.default_rng([seed, 3]).permutation(pool)
    return order[np.arange(n) % pool]


def sample_of(seed: int, pair: np.ndarray) -> list:
    """The requests whose responses are compared: for each pair of the
    pool, one of the requests that sent it, drawn from the seed."""
    rng = np.random.default_rng([seed, 4])
    return sorted(int(rng.choice(np.flatnonzero(pair == p)))
                  for p in np.unique(pair))


def raw_body(f0: np.ndarray, f1: np.ndarray) -> bytes:
    h, w = f0.shape[:2]
    return (struct.pack(">HH", h, w) + np.ascontiguousarray(f0).tobytes()
            + np.ascontiguousarray(f1).tobytes())


def post(port: int, body: bytes, timeout: float) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", PATH, body=body,
                     headers={"Content-Type": RAW_CONTENT_TYPE})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def run(port: int, bodies: list, due: np.ndarray, pair: np.ndarray,
        keep: set, senders: int, drain: float) -> dict:
    n = len(due)
    lat = [None] * n
    status = [0] * n
    late = [0.0] * n
    kept = {}
    jobs: queue.Queue = queue.Queue()
    idle = [senders]
    lock = threading.Lock()
    waited = [0]

    def sender():
        while True:
            k = jobs.get()
            if k is None:
                return
            t_send = time.perf_counter()
            late[k] = t_send - t0 - due[k]
            try:
                st, data = post(port, bodies[pair[k]], drain)
            except (OSError, http.client.HTTPException):
                st, data = -1, b""
            t_done = time.perf_counter()
            status[k] = st
            if st == 200:
                lat[k] = t_done - t0 - due[k]
                if k in keep:
                    kept[k] = data
            with lock:
                idle[0] += 1

    threads = [threading.Thread(target=sender, daemon=True)
               for _ in range(senders)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    for k in range(n):
        wait = t0 + due[k] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        with lock:
            if idle[0] <= 0:
                waited[0] += 1
            idle[0] -= 1
        jobs.put(k)
    deadline = t0 + due[-1] + drain
    while time.perf_counter() < deadline:
        with lock:
            if idle[0] == senders:
                break
        time.sleep(0.005)
    span = time.perf_counter() - t0
    for _ in threads:
        jobs.put(None)
    return {"n": n, "latency_s": lat, "status": status, "pair":
            pair.tolist(), "late_send_s": late, "sends_waited": waited[0],
            "span_s": span, "kept": kept}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--size", type=int, nargs=2, required=True)
    ap.add_argument("--crop", type=int, nargs=2, required=True)
    ap.add_argument("--pool", type=int, required=True)
    ap.add_argument("--senders", type=int, required=True)
    ap.add_argument("--drain", type=float, required=True)
    a = ap.parse_args(argv)
    from vfibench.inputs import make_pool

    f0, f1 = make_pool(a.seed, a.pool, tuple(a.size), tuple(a.crop))
    bodies = [raw_body(x, y) for x, y in zip(f0, f1)]
    due = schedule(a.seed, a.rate, a.seconds)
    pair = pairs_of(a.seed, len(due), a.pool)
    keep = set(sample_of(a.seed, pair))
    out = sys.stdout.buffer
    out.write(b"ready\n")
    out.flush()
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        return 2
    res = run(int(line[1]), bodies, due, pair, keep, a.senders, a.drain)
    kept = res.pop("kept")
    res["samples"] = [[k, int(pair[k]), len(kept[k])] for k in sorted(kept)]
    out.write(json.dumps(res).encode() + b"\n")
    for k in sorted(kept):
        out.write(kept[k])
    out.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
