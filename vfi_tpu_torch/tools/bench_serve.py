"""Closed-loop load generator for the interpolation server, port of
`tools/bench_serve.py`.

Measures online-serving throughput and latency percentiles against a
running server (`python -m vfi_tpu_torch.cli.serve`), or an in-process
one (`--inprocess`): N closed-loop clients POST a frame pair (or an
(N+1)-frame sequence) at a fixed resolution; reports requests/s,
midpoints/s, per-request latency p50/p99, and the server-side batching
stats (mean batch size = how well coalescing works at that concurrency).

The frames are RubberWhale's frame10/frame11 from
`data/processed/train`, decoded by the port's PNG decoder and resized
with `F.interpolate(mode="bilinear", antialias=True)`; where those are
missing, frames made from a seed.

Example (server on the card):
  python -m vfi_tpu_torch.cli.serve --model_path \
      artifacts/emavfi_qocc_best.npz --flow_prior --dcn_max_offset 1 \
      --warp_max_flow 16 --warmup 720x1280 &
  python -m vfi_tpu_torch.tools.bench_serve --url http://127.0.0.1:8000 \
      --size 720x1280 --clients 16 --requests 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from vfi_tpu_torch import native
from vfi_tpu_torch.ops.resize import resize_u8
from vfi_tpu_torch.serve import (RAW_CONTENT_TYPE, SEQ_CONTENT_TYPE,
                                 encode_pair_body, encode_raw_body,
                                 encode_seq_body)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "processed", "train",
    "RubberWhale")


def load_frames(h: int, w: int) -> list:
    """Two (h, w, 3) uint8 frames: RubberWhale's frame10 / frame11 where
    the data is present, else uniform noise from seed 0."""
    if os.path.isdir(DATA):
        out = []
        for name in ("frame10.png", "frame11.png"):
            with open(os.path.join(DATA, name), "rb") as f:
                out.append(resize_u8(native.decode_png_rgb(f.read()), h, w))
        return out
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            for _ in range(2)]


def make_body(a: np.ndarray, b: np.ndarray, raw: bool = False,
              seq: int = 0) -> bytes:
    """One request body for the pair (a, b): the PNG pair route, the raw
    route, or (seq > 0) a (seq+1)-frame sequence of linear blends from a
    to b (a video-like stream; one request = seq midpoints)."""
    if seq:
        n1 = seq + 1
        fr = np.stack([((a.astype(np.float32) * (1 - t / (n1 - 1))
                         + b.astype(np.float32) * (t / (n1 - 1)))
                        ).astype(np.uint8) for t in range(n1)])
        return encode_seq_body(fr)
    if raw:
        return encode_raw_body(a, b)
    return encode_pair_body(native.encode_png_rgb(a), native.encode_png_rgb(b))


def run_load(url: str, body, clients: int, total: int, timeout: float,
             raw: bool = False, seq: int = 0, keep: bool = False) -> dict:
    """`total` requests from `clients` closed-loop clients. `body` is one
    request body, or a list of them (request i sends body[i % len]);
    with `keep`, the result's `responses` holds each request's (status,
    bytes), status 0 where the request got no answer."""
    bodies = [body] if isinstance(body, bytes) else list(body)
    latencies: list[float] = []
    responses: list = [None] * total
    errors = [0]
    lock = threading.Lock()
    counter = iter(range(total))
    ctype = (SEQ_CONTENT_TYPE if seq else RAW_CONTENT_TYPE if raw
             else "application/octet-stream")

    def client():
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            t0 = time.monotonic()
            status, data = 0, b""
            try:
                req = urllib.request.Request(
                    url + "/v1/interpolate", data=bodies[i % len(bodies)],
                    headers={"Content-Type": ctype})
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    data = r.read()
                    status = r.status
            except urllib.error.HTTPError as e:
                status, data = e.code, e.read()
            except Exception:  # noqa: BLE001 - counted, not raised
                pass
            with lock:
                if status == 200:
                    latencies.append(time.monotonic() - t0)
                else:
                    errors[0] += 1
                if keep:
                    responses[i] = (status, data)

    t_start = time.monotonic()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start

    lat = sorted(latencies)

    def pct(p):
        return lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 if lat else None

    stats = None
    try:
        with urllib.request.urlopen(url + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
    except Exception:  # noqa: BLE001 - stats are best-effort
        pass
    result = {
        "clients": clients,
        "completed": len(lat),
        "errors": errors[0],
        "wall_s": wall,
        "requests_per_s": len(lat) / wall if wall else None,
        "midpoints_per_s": len(lat) * max(1, seq) / wall if wall else None,
        "latency_ms_p50": pct(0.50),
        "latency_ms_p99": pct(0.99),
        "server_stats": stats,
    }
    if keep:
        result["responses"] = responses
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--url", default=None,
                        help="base URL of a running server; omit with "
                             "--inprocess")
    parser.add_argument("--inprocess", action="store_true",
                        help="stand up an in-process server (needs "
                             "--model_path)")
    parser.add_argument("--model_path", default="artifacts/emavfi_q2_best.npz")
    parser.add_argument("--size", default="720x1280", help="HxW of the pair")
    parser.add_argument("--clients", type=int, default=16)
    parser.add_argument("--requests", type=int, default=64)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--max_px_per_launch", type=int, default=5_000_000,
                        help="memory guard (see cli/serve.py); 0 = uncapped")
    parser.add_argument("--max_delay_ms", type=float, default=5.0)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--use_pallas", action="store_true",
                        help="accepted for parity; no effect")
    parser.add_argument("--raw", action="store_true",
                        help="use the zero-codec raw-RGB protocol "
                             "(application/x-vfi-raw) instead of PNG")
    parser.add_argument("--seq", type=int, default=0,
                        help="N>0: each request is an (N+1)-frame raw "
                             "sequence -> N midpoints (ships each frame "
                             "once)")
    parser.add_argument("--f32_transfer", action="store_true",
                        help="in-process engine ships float32 to the device "
                             "instead of the default uint8")
    parser.add_argument("--dcn_max_offset", type=int, default=None)
    parser.add_argument("--warp_max_flow", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="in-process engine: cuda (default) or cpu")
    args = parser.parse_args(argv)

    h, w = (int(v) for v in args.size.lower().split("x"))
    body = make_body(*load_frames(h, w), raw=args.raw, seq=args.seq)

    server = None
    url = args.url
    if args.inprocess or url is None:
        from vfi_tpu_torch.cli.common import load_model_params
        from vfi_tpu_torch.infer.pair import FrameInterpolator
        from vfi_tpu_torch.serve import InterpolationServer

        engine = FrameInterpolator(load_model_params(args.model_path),
                                   dcn_max_offset=args.dcn_max_offset,
                                   warp_max_flow=args.warp_max_flow,
                                   io_uint8=not args.f32_transfer,
                                   device=args.device)
        server = InterpolationServer(engine, port=0,
                                     max_batch=args.max_batch,
                                     max_px_per_launch=(args.max_px_per_launch
                                                        or None),
                                     max_delay_ms=args.max_delay_ms,
                                     request_timeout=args.timeout).start()
        # Warm the exact route under test, so its first launch (kernel
        # build, cuDNN plans) falls outside the measurement window.
        t_warm = time.monotonic()
        if args.seq:
            server.warmup([(args.seq + 1, h, w)])
        else:
            server.warmup([(h, w)])
        print(f"# warmup {time.monotonic() - t_warm:.1f}s", file=sys.stderr)
        url = f"http://127.0.0.1:{server.port}"

    result = run_load(url, body, args.clients, args.requests, args.timeout,
                      raw=args.raw, seq=args.seq)
    result["size"] = f"{h}x{w}"
    result["protocol"] = (f"seq{args.seq}" if args.seq
                          else "raw" if args.raw else "png")
    result["max_batch"] = args.max_batch
    result["max_px_per_launch"] = args.max_px_per_launch or None
    if server is not None:
        result["launch_batch"] = server.batcher.launch_size((h, w))
    print(json.dumps(result))
    if server is not None:
        server.shutdown()
    return 0 if result["errors"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
