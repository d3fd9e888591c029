#!/usr/bin/env python3
"""Load generator of the service cells: a process of its own, standard
library only (http.client; no torch), so that its clock and its threads
share nothing with the server's interpreter.

It reads from standard input one JSON line (port, the traffic mix, the
seed, the pool's size) and then the pool of bodies, each as an 8-byte
little-endian length and its bytes.  It prints `ready`, waits for a line
`go SECONDS`, and then drives POST /v1/query for that window in an open
loop: arrivals at a fixed rate, the gaps the exponential distribution's
quantiles at (k + 0.5) / n in a seeded order, so that every seed offers
the same gaps.  Each request is timed from the moment it was due, on a
connection of its own (the service answers HTTP/1.0), and enough sender
threads are kept that sending never waits on a reply.

Bodies are taken in a seeded order of the pool, cycled.  On standard
error it prints how late it ran, the sample count and the slow connects;
its last line on standard output is one JSON object with every request:
[body, due, sent, done, status, answer text, connect], times in seconds
from `go`, connect the seconds the TCP connection took to open.
"""

from __future__ import annotations

import http.client
import json
import math
import queue
import random
import struct
import sys
import threading
import time

TIMEOUT_S = 120.0     # a reply later than this counts as never come


def schedule_open(rate: float, seconds: float, seed: int) -> list[float]:
    n = max(1, int(round(rate * seconds)))
    gaps = [-math.log(1.0 - (k + 0.5) / n) / rate for k in range(n)]
    random.Random(seed).shuffle(gaps)
    due, t = [], 0.0
    for gap in gaps:
        t += gap
        if t >= seconds:
            break
        due.append(t)
    return due


def body_order(pool: int, seed: int, count: int) -> list[int]:
    order = list(range(pool))
    random.Random(seed + 1).shuffle(order)
    return [order[k % pool] for k in range(count)]


def post(port: int, body: bytes):
    """(status, answer text, connect seconds) of one query; status 0 when
    no reply came."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    t0 = time.perf_counter()
    connect = None
    try:
        conn.connect()
        connect = time.perf_counter() - t0
        conn.request("POST", "/v1/query", body,
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace"), connect
    except (OSError, http.client.HTTPException) as e:
        return 0, f"{type(e).__name__}: {e}", connect
    finally:
        conn.close()


def run_open(port, bodies, traffic, seed, seconds, t0):
    due = schedule_open(float(traffic["rate"]), seconds, seed)
    which = body_order(len(bodies), seed, len(due))
    records = [None] * len(due)
    work: queue.Queue = queue.Queue()

    def sender():
        while True:
            k = work.get()
            if k is None:
                return
            sent = time.perf_counter() - t0
            status, text, connect = post(port, bodies[which[k]])
            records[k] = [which[k], due[k], sent,
                          time.perf_counter() - t0, status, text, connect]

    threads = [threading.Thread(target=sender, daemon=True)
               for _ in range(int(traffic.get("senders", 64)))]
    for t in threads:
        t.start()
    for k, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        work.put(k)
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join(TIMEOUT_S + 60)
    return records


def read_bodies(stream, count: int) -> list[bytes]:
    out = []
    for _ in range(count):
        (n,) = struct.unpack("<Q", stream.read(8))
        out.append(stream.read(n))
    return out


def main() -> int:
    stdin = sys.stdin.buffer
    head = json.loads(stdin.readline())
    bodies = read_bodies(stdin, int(head["pool"]))
    print("ready", flush=True)
    go = stdin.readline().split()
    if not go or go[0] != b"go":
        return 2
    traffic, seconds = head["traffic"], float(go[1])
    if traffic.get("loop", "open") != "open":
        print(f"loadgen: no {traffic['loop']!r} loop, only 'open'",
              file=sys.stderr, flush=True)
        return 2
    t0 = time.perf_counter()
    records = run_open(int(head["port"]), bodies, traffic, int(head["seed"]),
                       seconds, t0)
    missing = sum(1 for r in records if r is None)
    records = [r for r in records if r is not None]
    late = sorted(r[2] - r[1] for r in records)
    connects = sorted(r[6] for r in records if r[6] is not None)
    if late:
        print(f"loadgen: {len(records)} requests ({missing} never sent), "
              f"sends late by median {late[len(late) // 2] * 1e3:.3f} ms, "
              f"max {late[-1] * 1e3:.3f} ms; connects: "
              f"{len(records) - len(connects)} never opened, "
              f"{sum(c > 0.25 for c in connects)} over 250 ms, max "
              f"{(connects[-1] if connects else 0) * 1e3:.3f} ms",
              file=sys.stderr, flush=True)
    print(json.dumps({"records": records, "never_sent": missing}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
