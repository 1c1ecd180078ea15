"""The open-loop schedule: due times from the seed, and latency counted
from when a request was due, so a stall charges the requests behind it."""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from vfibench import openloop


def test_schedule_is_seeded_and_keeps_the_work_fixed():
    a = openloop.schedule(7, 40.0, 20.0)
    assert np.array_equal(a, openloop.schedule(7, 40.0, 20.0))
    b = openloop.schedule(8, 40.0, 20.0)
    assert len(a) == len(b) == 800
    assert a[0] == b[0] == 0.0
    assert np.all(np.diff(a) > 0) and a[-1] < 20.0
    ga = np.sort(np.diff(np.append(a, 20.0)))
    gb = np.sort(np.diff(np.append(b, 20.0)))
    assert np.allclose(ga, gb)                 # the same gaps ...
    assert not np.array_equal(a, b)            # ... in another order
    # exponential gaps: mean 1 / rate, a long tail
    assert np.isclose(np.diff(np.append(a, 20.0)).mean(), 1 / 40.0)
    assert ga[-1] > 4 * ga.mean()
    with pytest.raises(ValueError):
        openloop.schedule(1, 0.01, 1.0)


def test_pairs_and_sample_cover_the_pool():
    pair = openloop.pairs_of(3, 50, 16)
    assert np.bincount(pair, minlength=16).min() >= 3
    keep = openloop.sample_of(3, pair)
    assert sorted(pair[keep]) == list(range(16))
    assert keep == openloop.sample_of(3, pair)


class _Slow(BaseHTTPRequestHandler):
    delay = {0: 0.4}

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        body = self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(self.delay.get(body[0], 0.0))
        self.send_response(200)
        self.send_header("Content-Length", "1")
        self.end_headers()
        self.wfile.write(body[:1])


def test_latency_counts_from_the_due_time():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        due = np.array([0.0, 0.05, 0.10])
        bodies = [bytes([0]), bytes([1])]
        pair = np.array([0, 1, 1])
        # one sender: requests 1 and 2 wait behind the 0.4 s request 0
        res = openloop.run(srv.server_address[1], bodies, due, pair, {1},
                           senders=1, drain=5.0)
    finally:
        srv.shutdown()
        srv.server_close()
    assert res["status"] == [200, 200, 200]
    lat, late = res["latency_s"], res["late_send_s"]
    assert lat[0] >= 0.4
    assert late[1] >= 0.3 and lat[1] >= late[1]
    assert lat[2] >= 0.25 and late[2] >= 0.25
    assert res["sends_waited"] == 2
    assert res["kept"] == {1: bytes([1])}
