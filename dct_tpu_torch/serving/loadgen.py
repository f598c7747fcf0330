"""Load generation for the serving tier: qps, tail latency, saturation
(copied from ``dct_tpu/serving/loadgen.py``).

"Serves heavy traffic" is a slogan until it is a tracked number; this
module makes it one. Two generator shapes, both stdlib + numpy only:

- **Closed loop** — ``concurrency`` clients, each sending its next
  request the moment the previous response lands (keep-alive
  connections). Throughput at a fixed in-flight population: the shape
  that finds the saturation knee.
- **Open loop** — requests dispatched at a target arrival rate
  (``qps``) regardless of completions, the arrival process a real
  traffic front end faces; queueing delay shows up in the latency tail
  instead of being absorbed by back-pressure the way a closed loop
  hides it.

``sweep_closed_loop`` walks concurrency levels and reports the knee:
the last level whose throughput still improved materially over the
previous one — beyond it, added concurrency buys queue depth, not qps.

The CLI doubles as the CI smoke (``--selftest``): a synthetic MLP
behind a micro-batched server (the numpy engine on the CPU; the torch
engine on ``DCT_DEVICE``, default ``cuda:0``), fixed request counts at two
concurrency levels, asserting non-zero qps and batched responses equal to
sequential single-row scoring (bit for bit on the numpy engine, within
1e-5 on the torch engine), with no checkpoint IO.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time

import numpy as np


class _Collector:
    """Thread-safe latency/error/shed sink shared by generator threads.

    Admitted and shed traffic are SEPARATE populations: a 429 from
    admission control is neither a
    success nor an error — folding its (deliberately fast) turnaround
    into the latency list would flatter p50/p99, and counting it as an
    error would page on behavior the server chose. ``latencies`` holds
    admitted (200) requests only; ``shed_latencies`` the 429
    turnarounds; ``errors`` everything actually broken."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: list[float] = []
        self.shed_latencies: list[float] = []
        self.errors = 0

    def ok(self, seconds: float) -> None:
        with self.lock:
            self.latencies.append(seconds)

    def shed(self, seconds: float) -> None:
        with self.lock:
            self.shed_latencies.append(seconds)

    def fail(self) -> None:
        with self.lock:
            self.errors += 1


class _Client:
    """One keep-alive HTTP connection; reconnects on transport errors
    (a fresh connection per request would measure TCP setup, not the
    serving tier)."""

    def __init__(self, host: str, port: int, path: str = "/score",
                 timeout: float = 30.0, headers: dict | None = None):
        self.host, self.port, self.path = host, port, path
        self.timeout = timeout
        self.headers = dict(headers or {})
        #: Retry-After (seconds) off the most recent response, or None.
        self.last_retry_after: float | None = None
        self._conn: http.client.HTTPConnection | None = None

    def _connect(self) -> http.client.HTTPConnection:
        if self._conn is None:
            import socket

            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            self._conn.connect()
            # Nagle off, like the server side: a small POST body queued
            # behind its header otherwise waits out the peer's
            # delayed-ACK timer (~40 ms) on every keep-alive request.
            self._conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def post(self, body: bytes) -> tuple[int, bytes]:
        """(status, body); raises on transport failure after two
        reconnect attempts. Keep-alive connections drop legitimately,
        and a dying SO_REUSEPORT pool worker RSTs both its in-flight
        responses AND connections still in its accept queue — an
        IMMEDIATE reconnect can race that teardown window onto the same
        dying socket, so the second retry backs off a beat before
        dialing (by then the kernel routes to a surviving sibling)."""
        for attempt in (0, 1, 2):
            if attempt > 1:
                time.sleep(0.05)
            conn = self._connect()
            try:
                conn.request(
                    "POST", self.path, body,
                    {"Content-Type": "application/json", **self.headers},
                )
                resp = conn.getresponse()
                body_out = resp.read()
                self.last_retry_after = None
                if resp.status == 429:
                    # Prefer the precise jittered value in the JSON
                    # body (the header is RFC delta-seconds — integer,
                    # coarse); fall back to the header.
                    try:
                        self.last_retry_after = float(
                            json.loads(body_out)["retry_after_s"]
                        )
                    except (ValueError, KeyError, TypeError):
                        ra = resp.getheader("Retry-After")
                        try:
                            self.last_retry_after = (
                                float(ra) if ra is not None else None
                            )
                        except ValueError:
                            pass
                return resp.status, body_out
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt >= 2:
                    raise
        raise RuntimeError("unreachable")


def _percentile_ms(latencies: list[float], q: float) -> float | None:
    if not latencies:
        return None
    lat = sorted(latencies)
    idx = min(len(lat) - 1, int(q * len(lat)))
    return round(lat[idx] * 1e3, 4)


def _result(mode: str, concurrency: int, col: _Collector,
            wall: float, **extra) -> dict:
    n = len(col.latencies)
    out = {
        "mode": mode,
        "concurrency": concurrency,
        "requests": n,
        "errors": col.errors,
        "duration_s": round(wall, 3),
        "qps": round(n / wall, 1) if wall > 0 else 0.0,
        "p50_ms": _percentile_ms(col.latencies, 0.50),
        "p99_ms": _percentile_ms(col.latencies, 0.99),
    }
    shed = len(col.shed_latencies)
    if shed:
        # Admitted-vs-shed reported separately (the percentiles above
        # cover ADMITTED traffic only); keys appear only when admission
        # control actually fired, so unshedded sweeps stay byte-stable.
        out["shed"] = shed
        out["shed_fraction"] = round(shed / max(1, shed + n), 4)
        out["shed_p50_ms"] = _percentile_ms(col.shed_latencies, 0.50)
    out.update(extra)
    return out


def run_closed_loop(
    host: str, port: int, body: bytes, *,
    concurrency: int, total_requests: int = 300,
    duration_s: float = 30.0, path: str = "/score",
    headers: dict | None = None,
) -> dict:
    """``concurrency`` keep-alive clients ping-ponging until
    ``total_requests`` ADMITTED requests land or ``duration_s`` elapses
    (whichever first — the wall budget keeps a wedged or persistently
    overloaded server from wedging the bench).

    A 429 from admission control is honored, not hammered: the client
    backs off for the server's ``Retry-After`` (plus a small client-side
    jitter so a shed herd de-synchronizes), re-credits the request
    quota, and retries — the well-behaved-client contract the shed
    shape exists for. Sheds are reported separately and never poison
    the admitted percentiles (:class:`_Collector`)."""
    import random

    col = _Collector()
    remaining = [max(1, int(total_requests))]
    quota_lock = threading.Lock()
    deadline = time.perf_counter() + duration_s

    def worker():
        client = _Client(host, port, path, headers=headers)
        try:
            while time.perf_counter() < deadline:
                with quota_lock:
                    if remaining[0] <= 0:
                        return
                    remaining[0] -= 1
                t0 = time.perf_counter()
                try:
                    status, _ = client.post(body)
                except Exception:  # noqa: BLE001 — transport tear = error
                    col.fail()
                    continue
                if status == 200:
                    col.ok(time.perf_counter() - t0)
                elif status == 429:
                    col.shed(time.perf_counter() - t0)
                    with quota_lock:
                        remaining[0] += 1  # the admitted quota is unmet
                    pause = (client.last_retry_after or 0.05) * (
                        1.0 + 0.1 * random.random()
                    )
                    time.sleep(
                        min(pause,
                            max(0.0, deadline - time.perf_counter()))
                    )
                else:
                    col.fail()
        finally:
            client.close()

    threads = [
        threading.Thread(target=worker, daemon=True)
        for _ in range(max(1, int(concurrency)))
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_s + 30.0)
    return _result("closed", concurrency, col, time.perf_counter() - t0)


def run_open_loop(
    host: str, port: int, body: bytes, *,
    qps: float, duration_s: float = 2.0, max_inflight: int = 64,
    path: str = "/score", headers: dict | None = None,
) -> dict:
    """Arrivals paced at ``qps`` for ``duration_s``; each request runs
    on a pooled keep-alive client. If the pool is saturated
    (``max_inflight``), the arrival counts as a drop (reported) rather
    than silently back-pressuring the clock — an open-loop generator
    that waits is a closed loop in disguise. A 429 counts as SHED
    offered load (separate from errors; open-loop arrivals do not
    retry — the next arrival is already scheduled)."""
    col = _Collector()
    dropped = [0]
    pool: list[_Client] = [
        _Client(host, port, path, headers=headers)
        for _ in range(max_inflight)
    ]
    free = list(range(max_inflight))
    free_lock = threading.Lock()
    live: list[threading.Thread] = []

    def fire(idx: int):
        t0 = time.perf_counter()
        try:
            status, _ = pool[idx].post(body)
            if status == 200:
                col.ok(time.perf_counter() - t0)
            elif status == 429:
                col.shed(time.perf_counter() - t0)
            else:
                col.fail()
        except Exception:  # noqa: BLE001
            col.fail()
        finally:
            with free_lock:
                free.append(idx)

    interval = 1.0 / max(qps, 1e-6)
    start = time.perf_counter()
    n_arrivals = max(1, int(qps * duration_s))
    for i in range(n_arrivals):
        target = start + i * interval
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        with free_lock:
            idx = free.pop() if free else None
        if idx is None:
            dropped[0] += 1
            continue
        t = threading.Thread(target=fire, args=(idx,), daemon=True)
        live.append(t)
        t.start()
    for t in live:
        t.join(30.0)
    wall = time.perf_counter() - start
    for c in pool:
        c.close()
    return _result(
        "open", max_inflight, col, wall,
        target_qps=qps, dropped=dropped[0],
    )


def saturation_knee(levels: list[dict],
                    min_gain: float = 1.2) -> dict:
    """The knee of a closed-loop sweep: the last concurrency level whose
    qps still improved by ``min_gain``x over the previous level. Beyond
    it, added concurrency buys queue depth, not throughput."""
    knee = levels[0]
    for prev, cur in zip(levels, levels[1:]):
        if prev["qps"] > 0 and cur["qps"] >= min_gain * prev["qps"]:
            knee = cur
        else:
            break
    peak = max(levels, key=lambda r: r["qps"])
    return {
        "knee_concurrency": knee["concurrency"],
        "knee_qps": knee["qps"],
        "saturated_qps": peak["qps"],
        "saturated_concurrency": peak["concurrency"],
    }


def sweep_closed_loop(
    host: str, port: int, body: bytes, *,
    levels: list[int], requests_per_level: int = 300,
    duration_s: float = 30.0,
) -> dict:
    """Closed-loop sweep over ``levels`` + knee analysis — the
    load generator's sweep."""
    results = [
        run_closed_loop(
            host, port, body, concurrency=c,
            total_requests=requests_per_level, duration_s=duration_s,
        )
        for c in levels
    ]
    return {"levels": results, **saturation_knee(results)}


# ----------------------------------------------------------------------
# Synthetic fixture + selftest (the CI smoke; numpy + stdlib only).

def synthetic_mlp(seed: int = 0, input_dim: int = 5,
                  hidden: int = 64) -> tuple[dict, dict]:
    """A deterministic random MLP (weights, meta) pair shaped exactly
    like a deployed weather_mlp package — no training, no checkpoint."""
    rng = np.random.default_rng(seed)
    weights = {
        "w0": rng.standard_normal((input_dim, hidden)).astype(np.float32),
        "b0": rng.standard_normal(hidden).astype(np.float32) * 0.1,
        "w1": rng.standard_normal((hidden, 2)).astype(np.float32),
        "b1": rng.standard_normal(2).astype(np.float32) * 0.1,
    }
    meta = {
        "model": "weather_mlp", "input_dim": input_dim,
        "hidden_dim": hidden, "num_classes": 2,
        "feature_names": [f"f{i}_norm" for i in range(input_dim)],
    }
    return weights, meta


def _selftest(requests_per_level: int = 200, levels: tuple = (2, 8),
              engine: str = "numpy", device=None) -> dict:
    """The serving-load smoke: a micro-batched server over a synthetic
    MLP must (1) answer a concurrency sweep with non-zero qps and zero
    errors, and (2) answer as sequential single-row scoring does while
    requests are being merged: bit for bit on the numpy engine (on the
    CPU), within 1e-5 on the torch engine (on ``device``; ``None`` is
    ``cuda:0``)."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.runtime import score_payload
    from dct_tpu_torch.serving.server import make_server_from_weights

    weights, meta = synthetic_mlp()
    serving = ServingConfig(
        max_batch=32, batch_window_ms=2.0, workers=2, engine=engine
    )
    server = make_server_from_weights(weights, meta, serving=serving,
                                      device=device)
    host, port = server.server_address[:2]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(7)
        rows = rng.standard_normal((32, meta["input_dim"])).astype(
            np.float32
        )
        expected = [
            np.asarray(
                score_payload(weights, meta, [row.tolist()])
                ["probabilities"],
                np.float32,
            )
            for row in rows
        ]
        got: list = [None] * len(rows)

        def one(i: int):
            client = _Client(host, port)
            try:
                status, body = client.post(
                    json.dumps({"data": [rows[i].tolist()]}).encode()
                )
                if status == 200:
                    got[i] = np.asarray(
                        json.loads(body)["probabilities"], np.float32
                    )
            finally:
                client.close()

        threads = [
            threading.Thread(target=one, args=(i,), daemon=True)
            for i in range(len(rows))
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30.0)
        tol = 0.0 if engine == "numpy" else 1e-5
        parity = all(
            g is not None and g.shape == e.shape
            and bool(np.abs(g - e).max() <= tol)
            for g, e in zip(got, expected)
        )

        body = json.dumps({"data": [rows[0].tolist()]}).encode()
        sweep = sweep_closed_loop(
            host, port, body, levels=list(levels),
            requests_per_level=requests_per_level,
        )
        merged = server.batcher.flushes < (
            len(rows) + sum(r["requests"] for r in sweep["levels"])
        )
        ok = (
            parity
            and all(r["qps"] > 0 for r in sweep["levels"])
            and all(r["errors"] == 0 for r in sweep["levels"])
        )
        return {
            "ok": ok, "parity": parity, "batching_observed": merged,
            "engine": engine, **sweep,
        }
    finally:
        server.shutdown()
        server.server_close()


def main(argv: list[str] | None = None) -> int:
    import argparse
    import urllib.parse

    from dct_tpu_torch.config import ServingConfig

    cfg = ServingConfig.from_env()
    ap = argparse.ArgumentParser(
        description="dct_tpu_torch serving load generator"
    )
    ap.add_argument("--url", help="server base URL (http://host:port)")
    ap.add_argument("--mode", choices=("closed", "open"), default=None,
                    help="default: open when --qps/DCT_SERVE_LOADGEN_QPS "
                         "> 0, else closed")
    ap.add_argument("--concurrency", type=int, default=None,
                    help="closed loop: comma levels come from "
                         "DCT_SERVE_LOADGEN_CONCURRENCY when unset")
    ap.add_argument("--requests", type=int, default=cfg.loadgen_requests)
    ap.add_argument("--duration", type=float,
                    default=cfg.loadgen_duration_s)
    ap.add_argument("--qps", type=float, default=cfg.loadgen_qps)
    ap.add_argument("--rows", type=int, default=1,
                    help="feature rows (or windows) per request payload")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="rows per window for a sequence model (0: the "
                         "payload is rows of features)")
    ap.add_argument("--engine", choices=("numpy", "torch"),
                    default="numpy",
                    help="the selftest server's engine (torch: on "
                         "DCT_DEVICE, default cuda:0)")
    ap.add_argument("--selftest", action="store_true",
                    help="hermetic smoke: synthetic model, in-process "
                         "server, parity + qps assertions")
    args = ap.parse_args(argv)

    if args.selftest:
        out = _selftest(engine=args.engine,
                        device=os.environ.get("DCT_DEVICE") or None)
        print(json.dumps(out))
        return 0 if out["ok"] else 1

    if not args.url:
        ap.error("--url is required (or use --selftest)")
    parsed = urllib.parse.urlparse(args.url)
    host, port = parsed.hostname, parsed.port or 80
    rng = np.random.default_rng(0)
    shape = ((args.rows, args.seq_len, 5) if args.seq_len > 0
             else (args.rows, 5))
    body = json.dumps(
        {"data": rng.standard_normal(shape).round(4).tolist()}
    ).encode()

    mode = args.mode or ("open" if args.qps > 0 else "closed")
    if mode == "open":
        out = run_open_loop(
            host, port, body, qps=args.qps or 100.0,
            duration_s=args.duration,
        )
    elif args.concurrency:
        out = run_closed_loop(
            host, port, body, concurrency=args.concurrency,
            total_requests=args.requests, duration_s=args.duration,
        )
    else:
        out = sweep_closed_loop(
            host, port, body, levels=cfg.concurrency_levels(),
            requests_per_level=args.requests,
            duration_s=args.duration,
        )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
