"""HTTP scoring server (counterpart of ``dct_tpu/serving/server.py``).

The contract is the reference's:
- ``POST /score`` with ``{"data": [...]}`` -> 200 ``{"probabilities": ...}``;
  400 ``{"error": ...}`` for a malformed or invalid payload; 429 with a
  ``Retry-After`` when admission control sheds it; 500 for a scoring fault;
- ``GET /healthz`` -> 200 once the model is loaded;
- ``GET /metrics`` -> Prometheus text: the per-slot request, error and
  latency series, the batcher's batch-size and queue-depth histograms,
  admission's counters, the autoscaler's gauge, the process's kernel
  launches (``dct_kernel_launches``) and the promotion gate's ledger (:func:`~dct_tpu_torch.evaluation.gates.render_gate_metrics`).
  With ``DCT_METRICS_DIR`` set the scrape is fleet-wide: the process
  publishes its snapshot and merges every live sibling's
  (:mod:`dct_tpu_torch.observability.aggregate`), so one scrape of any
  pool process shows every ``proc``.

Two modes: :func:`make_server` (one checkpoint or package) and
:func:`make_endpoint_server` (a local rollout endpoint: requests route by
the live traffic map of :class:`~dct_tpu_torch.deploy.local.
LocalEndpointClient`, ``?slot=`` pins a slot, mirror traffic goes to the
shadow slot after the live reply is sent, and the state JSON is re-read
for each request so stage flips apply live). :class:`ServerPool` runs
either in N forked processes on one port (``SO_REUSEPORT``), respawning
crashed children under a :class:`~dct_tpu_torch.resilience.supervisor.
RestartPolicy` and scaling up and down with a graceful drain.

Scoring goes through the shared :class:`~dct_tpu_torch.serving.batching.
MicroBatcher` (engine ``torch`` on the card by default, or ``numpy``).
The warm start: before a torch-engine server binds its port it builds the
package's scorer and runs one forward, which loads the kernel libraries
(building them when missing), so the first request does not pay for it.

Planes not ported yet answer or raise naming their ROADMAP items:
``GET /debug/profile`` answers 501 (item 19); ``DCT_SLO_SPEC`` and
``DCT_TS_DIR`` raise (item 27); lineage nodes are not recorded (item 29).
"""

from __future__ import annotations

import json
import math
import os
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dct_tpu_torch.serving.batching import MicroBatcher, ScoringError
from dct_tpu_torch.serving.runtime import parse_envelope_array, validate_payload

_untraced_recorder = None


def _serve_recorder():
    """The span recorder of ``serving.score`` spans: the process default
    under ``DCT_SERVE_TRACE``, else a disabled one (no file, no lock)."""
    global _untraced_recorder
    from dct_tpu_torch.config import _env
    from dct_tpu_torch.observability import spans as _spans

    if _env("DCT_SERVE_TRACE", False, bool):
        return _spans.get_default()
    if _untraced_recorder is None:
        _untraced_recorder = _spans.SpanRecorder(None, trace_id="untraced")
    return _untraced_recorder


def _emit_default(component: str, event: str, **fields) -> None:
    """Late-bound emit through the process-default event log."""
    from dct_tpu_torch.observability import events as _events

    _events.get_default().emit(component, event, **fields)


def _refuse_unported_planes() -> None:
    """Raise for the reference's SLO and telemetry-history planes."""
    for var in ("DCT_SLO_SPEC", "DCT_TS_DIR"):
        if os.environ.get(var):
            raise NotImplementedError(
                f"{var} arms a plane not ported to dct_tpu_torch yet (the "
                "SLO monitor and the telemetry history): ROADMAP Queue A "
                "item 27"
            )


class _JsonHandler(BaseHTTPRequestHandler):
    """Strict JSON replies, quiet logs, the admission gate, the envelope
    parse and the scoring call. HTTP/1.1 keep-alive with Nagle off."""

    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def _reply(self, code: int, payload: dict,
               headers: dict | None = None) -> None:
        try:
            body = json.dumps(payload, allow_nan=False).encode()
        except ValueError:
            code = 500
            body = b'{"error": "non-finite values in response"}'
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet unless DCT_SERVE_LOG is set
        if os.environ.get("DCT_SERVE_LOG"):
            super().log_message(fmt, *args)

    def _admit(self) -> bool:
        """The admission gate, before parsing: True when the request may
        be scored, else a 429 with a backoff-shaped ``Retry-After`` (RFC
        delta-seconds in the header, the precise value in the body) has
        been sent."""
        ctl = getattr(self.server, "admission", None)
        if ctl is None:
            return True
        queued, est_wait = self.server.batcher.saturation()
        decision = ctl.decide(
            ctl.parse_class(self.headers), queued, est_wait,
            deadline_s=ctl.parse_deadline_s(self.headers),
        )
        if decision.admitted:
            return True
        self._reply(
            429,
            {"error": "overloaded: request shed by admission control",
             "priority": decision.cls, "reason": decision.reason,
             "retry_after_s": round(decision.retry_after_s, 3)},
            headers={"Retry-After": str(
                max(1, math.ceil(decision.retry_after_s)))},
        )
        return False

    def _reply_metrics(self) -> None:
        """``GET /metrics``: this process's series, or with the metrics
        plane armed the fleet's merged series, plus the gate ledger."""
        from dct_tpu_torch.evaluation.gates import render_gate_metrics
        from dct_tpu_torch.observability.prometheus import CONTENT_TYPE

        publisher = getattr(self.server, "metrics_publisher", None)
        if publisher is None:
            text = self.server.slot_metrics.prometheus_text()
        else:
            from dct_tpu_torch.observability import aggregate

            self.server.slot_metrics.refresh_launches()
            publisher.publish()
            text, _ = aggregate.aggregate_text(
                publisher.directory, stale_s=self.server.metrics_stale_s)
        body = (text + render_gate_metrics()).encode()
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_profile(self) -> None:
        self._reply(501, {"error": "GET /debug/profile (a torch.profiler "
                                   "capture of the serving process) is not "
                                   "ported yet: ROADMAP Queue A item 19"})

    def _read_body(self) -> bytes:
        """Drain the request body (keep-alive framing needs it read, even
        for a request about to be shed)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length) or b"{}"
        except (ValueError, TypeError):
            return b"{}"

    def _parse_data_envelope(self, body: bytes):
        """``{"data": ...}`` -> the data, or None after a 400."""
        try:
            if getattr(self.server, "fast_parse", False):
                arr = parse_envelope_array(body)
                if arr is not None:
                    return arr
            payload = json.loads(body)
            if not isinstance(payload, dict) or payload.get("data") is None:
                raise ValueError('payload must be {"data": [...]}')
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e)})
            return None
        return payload["data"]

    def _score(self, weights: dict, meta: dict, data, slot: str = "default"):
        """validate (400) -> score (500) -> ``(result or None,
        server_fault)``; only a server fault counts against a slot."""
        with _serve_recorder().span("serving.score", component="serving",
                                    slot=slot) as sp:
            try:
                x = validate_payload(meta, data)
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
                sp.set(status=400)
                return None, False
            try:
                probs = self.server.batcher.score(weights, meta, x, slot=slot)
            except Exception as e:  # noqa: BLE001 - past validation, any
                # failure is a server error.
                msg = (str(e) if isinstance(e, ScoringError)
                       else f"{type(e).__name__}: {e}")
                self._reply(500, {"error": msg})
                sp.set(status=500)
                return None, True
            sp.set(status=200, rows=int(x.shape[0]))
            return {"probabilities": probs.tolist()}, False


class ScoreHandler(_JsonHandler):
    """Single-model mode: the weights and meta ride on the server."""

    def do_GET(self):  # noqa: N802 (http.server API)
        route = urllib.parse.urlparse(self.path).path
        if route == "/metrics":
            self._reply_metrics()
            return
        if route == "/debug/profile":
            self._reply_profile()
            return
        if route != "/healthz":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        meta = self.server.model_meta
        self._reply(200, {
            "status": "ok",
            "model": meta.get("model", "weather_mlp"),
            "input_dim": int(meta.get("input_dim", 0)),
            "horizon": int(meta.get("horizon", 1)),
            "device": str(self.server.device),
        })

    def do_POST(self):  # noqa: N802 (http.server API)
        if self.path != "/score":
            self._read_body()
            self._reply(404, {"error": f"no route {self.path}"})
            return
        body = self._read_body()
        if not self._admit():
            return
        data = self._parse_data_envelope(body)
        if data is None:
            return
        t0 = time.perf_counter()
        result, server_fault = self._score(
            self.server.model_weights, self.server.model_meta, data)
        self.server.slot_metrics.record(
            "default", time.perf_counter() - t0, ok=not server_fault)
        if result is not None:
            self._reply(200, result)


class _BatchedHTTPServer(ThreadingHTTPServer):
    """Thread-per-connection front end over a shared
    :class:`MicroBatcher`; ``server_close`` stops the autoscaler, drains
    the batcher and retires the metrics snapshot."""

    daemon_threads = True
    # socketserver's default listen backlog is 5: a burst of new
    # connections past it would sit out TCP's SYN retry (1 s and more).
    request_queue_size = 128
    _reuse_port = False

    def server_bind(self):  # noqa: N802 (socketserver API)
        if self._reuse_port:
            import socket as _socket

            self.socket.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
        super().server_bind()

    def server_close(self):  # noqa: N802 (http.server API)
        super().server_close()
        for name in ("autoscaler", "batcher", "metrics_publisher"):
            part = getattr(self, name, None)
            if part is not None:
                part.close()


class _ReusePortHTTPServer(_BatchedHTTPServer):
    """``SO_REUSEPORT``: N pool processes listen on one port."""

    _reuse_port = True


# Seconds a closing pool's child has to drain after its SIGTERM before it
# is killed (the reference's close waits without bound).
POOL_CLOSE_GRACE_S = 30.0


def _reaped(pid: int) -> bool:
    """Reap ``pid`` if it has exited; True once it is gone (reaped here
    or by another waiter)."""
    try:
        done, _ = os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        return True
    return done == pid


class ServerPool:
    """Multi-process serving: ``processes`` forked children each run a
    full server (``build_server(host, port, reuse_port=True)``) on the same
    port through ``SO_REUSEPORT``; ``processes <= 1`` runs one server on a
    thread of this process.

    Each child exports its pool index as ``DCT_SERVE_PROC_INDEX`` and
    ``DCT_PROCESS_ID`` (so ``crash_worker@proc1`` binds to child 1),
    resolves its own device and drains on SIGTERM (finish in-flight
    requests, close, exit 0). CUDA cannot be re-initialized in a forked
    child, so the parent must not have touched CUDA before it forks (a
    parent with a CUDA context raises); ``python -m dct_tpu_torch.serve``
    builds the kernel libraries in the parent (``nvcc`` needs no context)
    so that every child only loads them.

    Self-healing: with a ``restart_policy``, an unexpected child death is
    classified (``classify_failure``), logged (``serve.pool_child_death``)
    and respawned after the policy's backoff (``serve.pool_respawn``);
    when deaths outrun the budget the circuit breaks
    (``serve.pool_circuit_open``, :meth:`wait` returns 1). Without a
    policy the first death tears the pool down (exit 1).
    :meth:`scale_up` forks more children; :meth:`scale_down` drains the
    newest (never below one) without tripping the failure path."""

    def __init__(self, build_server, *, processes: int = 1,
                 host: str = "127.0.0.1", port: int = 0,
                 restart_policy=None, emit=None):
        import socket as _socket
        import threading

        self.host = host
        self.pids: list[int] = []
        self.restart_policy = restart_policy
        self.restarts_used = 0
        self.circuit_open = False
        self._build_server = build_server
        self._emit = emit
        self._lock = threading.Lock()
        self._draining: set[int] = set()
        self._index: dict[int, int] = {}
        self._spawned = 0
        self._closing = False
        self._thread = None
        self._server = None
        # A bound, never-listening SO_REUSEPORT socket parks the port
        # number (so port=0 works) and receives no connections.
        self._reserve = _socket.socket()
        self._reserve.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._reserve.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
        self._reserve.bind((host, port))
        self.port = self._reserve.getsockname()[1]
        if processes <= 1:
            self._server = build_server(host, self.port, reuse_port=True)
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True)
            self._thread.start()
            return
        for _ in range(int(processes)):
            self._spawn()

    def _emit_event(self, event: str, **fields) -> None:
        try:
            (self._emit or _emit_default)("serve", event, **fields)
        except Exception:  # noqa: BLE001 - telemetry never fails the pool
            pass

    def _spawn(self) -> int:
        """Fork one child at the next pool index (-1 when closing). The
        fork and the pid's bookkeeping happen under the lock, so the
        reaper never sees a pid it does not know."""
        import signal
        import threading as _threading

        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError(
                "ServerPool: this process has a CUDA context, which a "
                "forked child cannot use; build the pool before anything "
                "in this process touches CUDA (each child resolves its "
                "own device)"
            )
        with self._lock:
            if self._closing:
                return -1
            index = self._spawned
            self._spawned += 1
            # The child starts with SIGTERM blocked and unblocks it once
            # its drain handler is installed: a SIGTERM sent in between
            # stays pending (Linux queues a blocked signal even where its
            # disposition, inherited from this process, is SIG_IGN).
            mask = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
            pid = None
            try:
                pid = os.fork()
            finally:
                if pid != 0:
                    signal.pthread_sigmask(signal.SIG_SETMASK, mask)
            if pid != 0:
                self.pids.append(pid)
                self._index[pid] = index
                return pid

        # ---- the forked child: serve until SIGTERM, then drain ---------
        code = 0
        try:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            try:
                import ctypes

                # The parent's death (even a SIGKILL) drains the child.
                libc = ctypes.CDLL(None, use_errno=True)
                libc.prctl(1, signal.SIGTERM, 0, 0, 0)  # PR_SET_PDEATHSIG
                if os.getppid() == 1:
                    os._exit(0)
            except Exception:  # noqa: BLE001 - best effort off Linux
                pass
            os.environ["DCT_SERVE_PROC_INDEX"] = str(index)
            os.environ["DCT_PROCESS_ID"] = str(index)
            server = self._build_server(self.host, self.port, reuse_port=True)

            def _drain(signum, frame):
                # shutdown() blocks until serve_forever returns: off the
                # main thread, which runs serve_forever.
                _threading.Thread(target=server.shutdown, daemon=True).start()

            signal.signal(signal.SIGTERM, _drain)
            signal.pthread_sigmask(signal.SIG_SETMASK, mask)
            server.serve_forever()
            server.server_close()
        except BaseException:  # noqa: BLE001 - a child never returns into
            # the parent's code: it reports and dies.
            import traceback

            traceback.print_exc()
            code = 1
        finally:
            os._exit(code)

    def size(self) -> int:
        """Live (non-draining) children; 1 in in-process mode."""
        if self._server is not None:
            return 1
        with self._lock:
            return len([p for p in self.pids if p not in self._draining])

    def scale_up(self, n: int = 1) -> list[int]:
        """Fork ``n`` more children; returns their pids."""
        spawned = []
        for _ in range(max(0, int(n))):
            pid = self._spawn()
            if pid < 0:
                break
            self._emit_event("serve.pool_spawn", pid=pid,
                             index=self._index.get(pid), size=self.size())
            spawned.append(pid)
        return spawned

    def scale_down(self, n: int = 1) -> list[int]:
        """Drain the ``n`` newest children (never below one): mark them
        draining, SIGTERM them; :meth:`wait` reaps them quietly."""
        import signal

        victims: list[int] = []
        with self._lock:
            live = [p for p in self.pids if p not in self._draining]
            while live and len(live) > 1 and len(victims) < max(0, int(n)):
                pid = live.pop()
                victims.append(pid)
                self._draining.add(pid)
        for pid in victims:
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        return victims

    def wait(self) -> int:
        """Block until the pool stops serving: 0 after a clean close or
        drain, 1 when a death tore it down or the circuit opened."""
        from dct_tpu_torch.resilience.supervisor import (
            FREE_RESTARTS,
            classify_failure,
        )

        if self._server is not None:
            if self._thread is not None:
                self._thread.join()
            return 0
        if not self.pids:
            return 1
        while True:
            try:
                pid, status = os.waitpid(-1, 0)
            except OSError:
                return 0 if self._closing else 1
            code = os.waitstatus_to_exitcode(status)
            with self._lock:
                known = pid in self.pids
                if known:
                    self.pids.remove(pid)
                index = self._index.pop(pid, None)
                draining = pid in self._draining
                self._draining.discard(pid)
                closing = self._closing
                remaining = len(self.pids)
            if not known:
                continue
            if closing:
                if remaining == 0:
                    return 0
                continue
            if draining:
                self._emit_event("serve.pool_drained", pid=pid, code=code,
                                 index=index, size=remaining)
                if remaining == 0:
                    return 0
                continue
            classification = classify_failure([code])
            if classification == "success":
                # A serving child has no business exiting on its own.
                classification = "crash"
            self._emit_event("serve.pool_child_death", pid=pid, code=code,
                             classification=classification, index=index,
                             size=remaining)
            if self.restart_policy is None:
                self.close()
                return 1
            if not self.restart_policy.allows(self.restarts_used,
                                              classification):
                self.circuit_open = True
                self._emit_event("serve.pool_circuit_open",
                                 restarts_used=self.restarts_used,
                                 classification=classification)
                self.close()
                return 1
            delay = self.restart_policy.delay(self.restarts_used)
            if classification not in FREE_RESTARTS:
                self.restarts_used += 1
            time.sleep(delay)
            new_pid = self._spawn()
            if new_pid < 0:
                continue
            self._emit_event("serve.pool_respawn", pid=new_pid, died=pid,
                             backoff_s=round(delay, 3),
                             restarts_used=self.restarts_used,
                             classification=classification)

    def close(self) -> None:
        """Stop serving: SIGTERM every child and reap it; SIGKILL a child
        still alive after ``POOL_CLOSE_GRACE_S`` (``serve.pool_kill``)."""
        import signal

        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._thread is not None:
                self._thread.join(10.0)
            self._server = None
            self._thread = None
        with self._lock:
            self._closing = True
            pids = list(self.pids)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + POOL_CLOSE_GRACE_S
        live = [pid for pid in pids if not _reaped(pid)]
        while live and time.monotonic() < deadline:
            time.sleep(0.02)
            live = [pid for pid in live if not _reaped(pid)]
        if live:
            self._emit_event("serve.pool_kill", pids=live,
                             grace_s=POOL_CLOSE_GRACE_S)
        for pid in live:
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except OSError:
                pass  # wait() reaped it first
        with self._lock:
            self.pids = [p for p in self.pids if p not in pids]
            self._draining.clear()
        try:
            self._reserve.close()
        except OSError:
            pass

    def __enter__(self) -> "ServerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


#: Buckets of the batch-rows / queue-depth histograms.
_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class _SlotMetrics:
    """Per-slot request metrics on a
    :class:`~dct_tpu_torch.observability.metrics.MetricsRegistry` (the
    shape the metrics plane publishes and merges): requests, server-fault
    errors and latency by slot, and the batcher's batch-rows, requests per
    flush and queue-depth histograms; a window of the last 1024 latencies
    per slot gives ``snapshot()``'s p50 and p99."""

    def __init__(self):
        import threading

        from dct_tpu_torch.observability.metrics import MetricsRegistry

        self._lock = threading.Lock()
        self._by_slot: dict = {}
        self.publisher = None
        self.registry = MetricsRegistry()
        self._req = self.registry.counter(
            "dct_requests_total", "Scoring requests served, by deployment slot.")
        self._err = self.registry.counter(
            "dct_request_errors_total",
            "Server-fault scoring errors, by deployment slot (client 4xx "
            "never counts against a slot).")
        self._lat = self.registry.histogram(
            "dct_request_latency_seconds",
            "End-to-end scoring latency, by deployment slot.")
        hist = self.registry.histogram
        self._batch_rows_h = hist(
            "dct_serve_batch_rows",
            "Rows scored per micro-batch flush (server-wide).",
            buckets=_SIZE_BUCKETS)
        self._batch_requests_h = hist(
            "dct_serve_batch_requests",
            "Logical requests merged per micro-batch flush.",
            buckets=_SIZE_BUCKETS)
        self._queue_depth_h = hist(
            "dct_serve_queue_depth",
            "Rows still queued behind each flush (saturation signal).",
            buckets=_SIZE_BUCKETS)
        self._launches = self.registry.gauge(
            "dct_kernel_launches",
            "Kernel launches of this process since its counts were last "
            "reset, by kernel (summed over the fleet).", agg="sum")
        # Read handles (tests, diagnostics); all writes go through the
        # histograms above, under the registry's lock.
        self._batch_rows = self._batch_rows_h.accumulator()
        self._batch_requests = self._batch_requests_h.accumulator()
        self._queue_depth = self._queue_depth_h.accumulator()

    def _offer_publish(self) -> None:
        if self.publisher is not None:
            try:
                self.publisher.maybe_publish()
            except Exception:  # noqa: BLE001 - telemetry never fails serving
                pass

    def observe_batch(self, rows: int, requests: int, queue_depth: int):
        self._batch_rows_h.observe(rows)
        self._batch_requests_h.observe(requests)
        self._queue_depth_h.observe(queue_depth)
        self.refresh_launches()
        self._offer_publish()

    def refresh_launches(self) -> None:
        """Copy the flash wrappers' launch counts into the gauge."""
        from dct_tpu_torch.ops.flash_attention import launch_counts

        for name, n in launch_counts().items():
            self._launches.set(float(n), {"kernel": name})

    def record(self, slot: str, seconds: float, ok: bool) -> None:
        labels = {"slot": slot}
        with self._lock:
            m = self._by_slot.setdefault(
                slot, {"requests": 0, "errors": 0, "lat": []})
            m["requests"] += 1
            if not ok:
                m["errors"] += 1
            m["lat"].append(seconds)
            del m["lat"][:-1024]
        self._req.inc(1.0, labels)
        # inc(0) materializes a clean slot's error series at 0.
        self._err.inc(0.0 if ok else 1.0, labels)
        self._lat.observe(seconds, labels)
        self._offer_publish()

    def snapshot(self) -> dict:
        import statistics

        with self._lock:
            out = {}
            for slot, m in self._by_slot.items():
                lat = sorted(m["lat"])
                entry = {"requests": m["requests"], "errors": m["errors"]}
                if lat:
                    entry["p50_ms"] = round(statistics.median(lat) * 1e3, 3)
                    entry["p99_ms"] = round(
                        lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3, 3)
                out[slot] = entry
            return out

    def prometheus_text(self) -> str:
        self.refresh_launches()
        return self.registry.render()


def _arm_metrics_plane(server) -> None:
    """With ``DCT_METRICS_DIR`` set: a snapshot publisher over the slot
    metrics' registry (throttled on the request path, timer-refreshed when
    idle), read back by every scrape."""
    from dct_tpu_torch.config import ObservabilityConfig

    obs = ObservabilityConfig.from_env()
    if not obs.metrics_dir:
        return
    from dct_tpu_torch.observability.aggregate import SnapshotPublisher

    server.metrics_publisher = SnapshotPublisher(
        server.slot_metrics.registry, obs.metrics_dir,
        proc=f"serve-{os.getpid()}", interval_s=obs.metrics_publish_s)
    server.slot_metrics.publisher = server.metrics_publisher
    server.metrics_stale_s = obs.metrics_stale_s


def _new_score_server(handler_cls, host: str, port: int, serving, *,
                      reuse_port: bool = False, device=None, prepare=None):
    """Shared construction of both modes: the metrics, the micro-batcher,
    ``prepare(batcher)`` (the warm start) before the port is bound, then
    the server, admission control, the in-process autoscaler and the
    metrics plane."""
    from dct_tpu_torch.config import ServingConfig

    _refuse_unported_planes()
    serving = serving or ServingConfig.from_env()
    if serving.engine == "torch":
        from dct_tpu_torch.device import resolve_device

        device = resolve_device(device)
    else:
        import torch

        device = torch.device("cpu")
    slot_metrics = _SlotMetrics()
    batcher = MicroBatcher(
        max_batch=serving.max_batch, window_ms=serving.batch_window_ms,
        workers=serving.workers, engine=serving.engine, device=device,
        metrics=slot_metrics)
    try:
        if prepare is not None:
            prepare(batcher)
        cls = _ReusePortHTTPServer if reuse_port else _BatchedHTTPServer
        server = cls((host, port), handler_cls)
    except BaseException:
        batcher.close()
        raise
    server.slot_metrics = slot_metrics
    server.batcher = batcher
    server.device = device
    server.fast_parse = serving.fast_parse
    server.admission = None
    server.autoscaler = None
    server.metrics_publisher = None
    if serving.admit:
        from dct_tpu_torch.serving.admission import AdmissionController

        if serving.workers <= 0:
            import sys

            print("[serving] DCT_SERVE_ADMIT=1 with DCT_SERVE_WORKERS=0: "
                  "inline scoring has no queue to bound, so admission "
                  "control cannot shed in this mode",
                  file=sys.stderr, flush=True)
        server.admission = AdmissionController.from_config(
            serving, metrics_registry=slot_metrics.registry,
            emit=_emit_default)
    if serving.autoscale and serving.processes <= 1:
        # In a pool the parent scales processes instead.
        from dct_tpu_torch.serving.autoscale import (
            Autoscaler,
            WorkerScaleTarget,
            batcher_signal_fn,
        )

        server.autoscaler = Autoscaler.from_config(
            WorkerScaleTarget(batcher), serving,
            signal_fn=batcher_signal_fn(server), emit=_emit_default,
            registry=slot_metrics.registry,
        ).start()
    _arm_metrics_plane(server)
    return server


def make_server_from_weights(weights: dict, meta: dict, *,
                             host: str = "127.0.0.1", port: int = 0,
                             device=None, serving=None,
                             reuse_port: bool = False, warm: bool = True):
    """A ready (unstarted) single-model server over serving weights (flax
    keys or the MLP's ``w<i>``/``b<i>``, f32 arrays or ``QuantTensor``
    leaves) and their meta. ``port=0`` binds an ephemeral port
    (``server.server_address[1]``); ``serving`` is a
    :class:`~dct_tpu_torch.config.ServingConfig` (default: from env);
    ``device=None`` is ``cuda:0`` for the torch engine. ``warm=False``
    skips the warm start (it exists to measure the warm start)."""

    def prepare(batcher):
        if warm and batcher.engine == "torch":
            batcher.scorer_for(weights, meta).warm()

    server = _new_score_server(ScoreHandler, host, port, serving,
                               reuse_port=reuse_port, device=device,
                               prepare=prepare)
    server.model_weights = weights
    server.model_meta = meta
    # The single model's torch scorer (None for the numpy engine).
    server.scorer = (server.batcher.scorer_for(weights, meta)
                     if server.batcher.engine == "torch" else None)
    return server


def make_server(path: str, *, host: str = "127.0.0.1", port: int = 0,
                device=None, serving=None, reuse_port: bool = False,
                warm: bool = True):
    """Serve a checkpoint (a ``*.ckpt`` file, through
    :func:`~dct_tpu_torch.serving.score_gen.weights_from_checkpoint`) or a
    package directory (``model.npz`` + ``model_meta.json``): a ready,
    unstarted server."""
    if os.path.isdir(path):
        from dct_tpu_torch.serving.package import load_package

        weights, meta = load_package(path)
    else:
        from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

        weights, meta = weights_from_checkpoint(path)
    return make_server_from_weights(
        weights, meta, host=host, port=port, device=device, serving=serving,
        reuse_port=reuse_port, warm=warm)


class _PackageCache:
    """Thread-safe weights cache keyed by package dir. Entries whose
    package no longer backs any deployment are evicted on the next load;
    eviction is generation-gated by the state file's mtime, so a request
    holding an older snapshot never evicts what a newer one made live.
    Concurrent first loads of one package may both run the loader; the
    first store wins."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._entries: dict = {}
        self._generation = -1
        self._live: set = set()

    def get_or_load(self, pkg: str, loader, live_pkgs,
                    generation: int = 0) -> tuple:
        with self._lock:
            if generation >= self._generation:
                self._generation = generation
                self._live = set(live_pkgs)
                for stale in set(self._entries) - self._live:
                    del self._entries[stale]
            cached = self._entries.get(pkg)
        if cached is None:
            loaded = loader()
            with self._lock:
                if pkg in self._live or generation >= self._generation:
                    cached = self._entries.setdefault(pkg, loaded)
                else:
                    # Retired while a straggler loaded it: serve it once,
                    # do not resurrect it into the cache.
                    cached = loaded
        return cached


class EndpointScoreHandler(_JsonHandler):
    """Rollout-endpoint mode (module docstring)."""

    def _client(self):
        from dct_tpu_torch.deploy.local import LocalEndpointClient

        # The mtime before the read: the generation can only understate
        # the snapshot's age.
        try:
            self._state_generation = os.stat(
                self.server.state_path).st_mtime_ns
        except (OSError, TypeError):
            self._state_generation = 0
        return LocalEndpointClient(state_path=self.server.state_path)

    def _load_slot(self, client, slot: str):
        return _load_slot(self.server.package_cache,
                          self.server.endpoint_name, client, slot,
                          getattr(self, "_state_generation", 0))

    def do_GET(self):  # noqa: N802 (http.server API)
        route = urllib.parse.urlparse(self.path).path
        if route == "/metrics":
            self._reply_metrics()
            return
        if route == "/debug/profile":
            self._reply_profile()
            return
        if route != "/healthz":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        client = self._client()
        name = self.server.endpoint_name
        if not client.endpoint_exists(name):
            self._reply(503, {"error": f"endpoint {name} not provisioned"})
            return
        self._reply(200, {
            "status": "ok", "endpoint": name,
            "traffic": client.get_traffic(name),
            "mirror_traffic": client.get_mirror_traffic(name),
            "deployments": client.list_deployments(name),
            "metrics": self.server.slot_metrics.snapshot(),
            "device": str(self.server.device),
        })

    def do_POST(self):  # noqa: N802 (http.server API)
        import random

        parsed = urllib.parse.urlparse(self.path)
        body = self._read_body()
        if parsed.path != "/score":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        if not self._admit():
            return
        data = self._parse_data_envelope(body)
        if data is None:
            return
        client = self._client()
        name = self.server.endpoint_name
        if not client.endpoint_exists(name):
            self._reply(503, {"error": f"endpoint {name} not provisioned"})
            return
        live = {k: v for k, v in client.get_traffic(name).items() if v > 0}
        pinned = urllib.parse.parse_qs(parsed.query).get("slot")
        if pinned:
            slot = pinned[0]
        elif live:
            # Weighted random routing: a canary's 10% is a real 10%.
            slot = random.choices(list(live), weights=list(live.values()))[0]
        else:
            self._reply(503, {"error": f"endpoint {name} has no live traffic"})
            return
        if slot not in client.list_deployments(name):
            self._reply(404, {"error": f"no deployment {slot!r} on {name}"})
            return
        t0 = time.perf_counter()
        try:
            weights, meta = self._load_slot(client, slot)
        except Exception as e:  # noqa: BLE001 - an unreadable package
            self.server.slot_metrics.record(slot, time.perf_counter() - t0,
                                            ok=False)
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        result, server_fault = self._score(weights, meta, data, slot=slot)
        self.server.slot_metrics.record(slot, time.perf_counter() - t0,
                                        ok=not server_fault)
        if result is None:
            return
        self._reply(200, {**result, "slot": slot})
        # Mirror traffic after the live reply: a slow or broken shadow
        # never touches live latency; its outcome counts under its slot.
        for shadow, pct in client.get_mirror_traffic(name).items():
            if (pct > 0 and shadow != slot
                    and shadow in client.list_deployments(name)
                    and random.random() * 100 < pct):
                ts = time.perf_counter()
                try:
                    w_s, m_s = self._load_slot(client, shadow)
                    p_s = self.server.batcher.score(
                        w_s, m_s, validate_payload(m_s, data), slot=shadow)
                    shadow_ok = True
                    client.append_mirror_record({
                        "ts": round(time.time(), 6), "endpoint": name,
                        "live_slot": slot, "shadow_slot": shadow,
                        "live_probs": result["probabilities"],
                        "shadow_probs": p_s.tolist(),
                    })
                except Exception:  # noqa: BLE001 - invisible to the caller
                    shadow_ok = False
                self.server.slot_metrics.record(
                    shadow, time.perf_counter() - ts, ok=shadow_ok)


def _load_slot(cache: _PackageCache, endpoint: str, client, slot: str,
               generation: int = 0):
    """(weights, meta) of a slot through a server's package cache."""
    deployments = client.endpoints[endpoint].deployments
    return cache.get_or_load(
        deployments[slot].package_dir,
        lambda: client.load_slot(endpoint, slot),
        [d.package_dir for d in deployments.values()],
        generation=generation,
    )


def make_endpoint_server(endpoint: str, *, state_path: str | None = None,
                         host: str = "127.0.0.1", port: int = 0,
                         device=None, serving=None, reuse_port: bool = False,
                         warm: bool = True):
    """HTTP server over the local rollout endpoint ``endpoint`` whose
    state lives at ``state_path`` (default: ``DCT_LOCAL_ENDPOINT_STATE``).
    The warm start builds and warms the torch scorer of every slot
    deployed when the server starts; a slot deployed later is built on its
    first request."""
    from dct_tpu_torch.deploy.local import LocalEndpointClient

    state_path = state_path or os.environ.get("DCT_LOCAL_ENDPOINT_STATE")
    cache = _PackageCache()

    def prepare(batcher):
        if not (warm and batcher.engine == "torch"):
            return
        client = LocalEndpointClient(state_path=state_path)
        if not client.endpoint_exists(endpoint):
            return
        for slot in client.list_deployments(endpoint):
            weights, meta = _load_slot(cache, endpoint, client, slot)
            batcher.scorer_for(weights, meta).warm()

    server = _new_score_server(EndpointScoreHandler, host, port, serving,
                               reuse_port=reuse_port, device=device,
                               prepare=prepare)
    server.endpoint_name = endpoint
    server.state_path = state_path
    server.package_cache = cache
    return server


def serve_forever(path: str, *, host: str = "0.0.0.0", port: int = 8901,
                  device=None) -> None:
    """Serve a checkpoint or package until interrupted."""
    server = make_server(path, host=host, port=port, device=device)
    print(f"serving {server.model_meta.get('model', 'weather_mlp')} from "
          f"{path} on {server.device} at http://{host}:"
          f"{server.server_address[1]} (POST /score, GET /healthz, "
          "GET /metrics)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
