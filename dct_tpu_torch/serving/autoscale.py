"""Closed-loop serving autoscaler (counterpart of
``dct_tpu/serving/autoscale.py``): capacity follows the queue.

A controller thread polls the overload signals and scales the serving
capacity between ``DCT_SERVE_SCALE_MIN`` and ``DCT_SERVE_SCALE_MAX``:

- **pool mode** (``python -m dct_tpu_torch.serve``, ``DCT_SERVE_PROCS >
  1``): the scaled axis is ServerPool processes; scale-up starts a fresh
  SO_REUSEPORT worker, scale-down SIGTERMs the newest child into a
  graceful drain;
- **in-process mode** (``processes <= 1``): the axis is the
  micro-batcher's scoring threads
  (:meth:`~dct_tpu_torch.serving.batching.MicroBatcher.set_workers`).

Anti-flap guards, both mandatory: **hysteresis** (a decision needs
``DCT_SERVE_SCALE_HYSTERESIS`` consecutive agreeing polls) and
**cooldown** (no further event for ``DCT_SERVE_SCALE_COOLDOWN_S`` after
one).

Signals per poll (a pluggable ``signal_fn``): queue depth in rows (pool
mode reads the fleet ``dct_serve_queue_depth`` histogram delta off the
metrics plane, :mod:`dct_tpu_torch.observability.aggregate`) and the
admission controller's shed rate. The reference's SLO-burn and
telemetry-history signals belong to planes not yet ported (ROADMAP
Queue A item 27), so ``slo_burning`` is only ever what a caller's
``signal_fn`` reports.

Evidence: ``autoscale.scale_up`` / ``autoscale.scale_down`` events and a
``dct_serve_procs`` gauge (``dct_serve_workers`` in-process) on the
metrics plane.
"""

from __future__ import annotations

import os
import threading
import time


def emit_default(component: str, event: str, **fields) -> None:
    """Late-bound emit through the process-default event log (resolved
    per call, like the server's — env-built sinks and monkeypatched
    tests both see their own log)."""
    from dct_tpu_torch.observability import events as _events

    _events.get_default().emit(component, event, **fields)


class WorkerScaleTarget:
    """Scale axis = the micro-batcher's scoring threads."""

    gauge_name = "dct_serve_workers"

    def __init__(self, batcher):
        self._batcher = batcher

    def current(self) -> int:
        return self._batcher.workers

    def scale_to(self, n: int) -> None:
        self._batcher.set_workers(n)


class PoolScaleTarget:
    """Scale axis = ServerPool processes (``python -m dct_tpu_torch.serve``)."""

    gauge_name = "dct_serve_procs"

    def __init__(self, pool):
        self._pool = pool

    def current(self) -> int:
        return self._pool.size()

    def scale_to(self, n: int) -> None:
        cur = self._pool.size()
        if n > cur:
            self._pool.scale_up(n - cur)
        elif n < cur:
            self._pool.scale_down(cur - n)


class Autoscaler:
    """The controller. ``observe()`` is the pure-ish decision step the
    unit tests drive directly; ``start()`` runs it on a poll thread."""

    def __init__(
        self,
        target,
        *,
        min_size: int = 1,
        max_size: int = 4,
        poll_s: float = 1.0,
        up_queue_rows: float = 32.0,
        down_queue_rows: float = 2.0,
        hysteresis_polls: int = 2,
        cooldown_s: float = 5.0,
        signal_fn=None,
        emit=None,
        registry=None,
        clock=time.monotonic,
    ):
        self.target = target
        self.min_size = max(1, int(min_size))
        self.max_size = max(self.min_size, int(max_size))
        self.poll_s = max(0.05, float(poll_s))
        self.up_queue_rows = float(up_queue_rows)
        self.down_queue_rows = float(down_queue_rows)
        self.hysteresis_polls = max(1, int(hysteresis_polls))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.signal_fn = signal_fn
        self._emit = emit
        self._clock = clock
        self._above = 0
        self._below = 0
        self._last_scale: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.events = 0  # lifetime scale events (tests/diagnostics)
        self._gauge = None
        if registry is not None:
            self._gauge = registry.gauge(
                target.gauge_name,
                "Current serving capacity units under autoscaler "
                "control.", agg="last",
            )
            self._gauge.set(float(target.current()))

    @classmethod
    def from_config(cls, target, serving, **kw):
        """Autoscaler from a :class:`~dct_tpu_torch.config.ServingConfig`."""
        return cls(
            target,
            min_size=serving.scale_min,
            max_size=serving.scale_max,
            poll_s=serving.scale_poll_s,
            up_queue_rows=serving.scale_up_queue,
            down_queue_rows=serving.scale_down_queue,
            hysteresis_polls=serving.scale_hysteresis,
            cooldown_s=serving.scale_cooldown_s,
            **kw,
        )

    # -- decision step --------------------------------------------------

    def observe(
        self,
        queue_rows: float,
        *,
        slo_burning: bool = False,
        shed_rate: float = 0.0,
    ) -> str | None:
        """One poll: fold the signals into the hysteresis counters and
        apply at most one size step. Returns "up" / "down" / None."""
        overload = (
            queue_rows >= self.up_queue_rows
            or slo_burning
            or shed_rate > 0
        )
        idle = (
            queue_rows <= self.down_queue_rows
            and not slo_burning
            and shed_rate <= 0
        )
        self._above = self._above + 1 if overload else 0
        self._below = self._below + 1 if idle else 0
        now = self._clock()
        in_cooldown = (
            self._last_scale is not None
            and now - self._last_scale < self.cooldown_s
        )
        size = self.target.current()
        if self._gauge is not None:
            self._gauge.set(float(size))
        direction = None
        if (
            overload
            and self._above >= self.hysteresis_polls
            and not in_cooldown
            and size < self.max_size
        ):
            direction = "up"
            new = size + 1
        elif (
            idle
            and self._below >= self.hysteresis_polls
            and not in_cooldown
            and size > self.min_size
        ):
            direction = "down"
            new = size - 1
        if direction is None:
            return None
        self.target.scale_to(new)
        self._last_scale = now
        self._above = self._below = 0
        self.events += 1
        if self._gauge is not None:
            self._gauge.set(float(new))
        if self._emit is not None:
            try:
                self._emit(
                    "autoscale", f"autoscale.scale_{direction}",
                    size_from=size, size_to=new,
                    queue_rows=round(float(queue_rows), 1),
                    slo_burning=bool(slo_burning),
                    shed_rate=round(float(shed_rate), 3),
                )
            except Exception:  # noqa: BLE001 — telemetry never blocks scaling
                pass
        return direction

    # -- poll loop ------------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._loop, name="dct-serve-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self.signal_fn is None:
                # No signal source = no evidence: HOLD. A blind
                # controller reading "queue 0" forever would otherwise
                # drain a loaded pool to the floor.
                continue
            try:
                sig = self.signal_fn()
                self.observe(
                    float(sig.get("queue_rows", 0.0)),
                    slo_burning=bool(sig.get("slo_burning", False)),
                    shed_rate=float(sig.get("shed_rate", 0.0)),
                )
            except Exception:  # noqa: BLE001 — a flaky signal source must
                # not kill the control loop; the next poll retries.
                continue

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None


# ----------------------------------------------------------------------
# Signal sources.

def batcher_signal_fn(server):
    """In-process signals straight off the server's own batcher and
    admission controller (no metrics plane needed)."""
    state = {"sheds": 0.0}

    def signal() -> dict:
        out = {"queue_rows": float(server.batcher.queued_rows())}
        admission = getattr(server, "admission", None)
        if admission is not None:
            total = admission.shed_total()
            out["shed_rate"] = max(0.0, total - state["sheds"])
            state["sheds"] = total
        return out

    return signal


def pool_signal_fn(metrics_dir: str, *, stale_s: float | None = None,
                   clock=time.time):
    """Fleet signals for the pool parent, read off the metrics plane: the
    average queue depth behind recent flushes (histogram delta between
    polls) and the shed-counter delta."""
    from dct_tpu_torch.observability import aggregate

    if stale_s is None:
        stale_s = aggregate.DEFAULT_STALE_S
    state: dict = {"q": None, "sheds": None}

    def signal() -> dict:
        merged = aggregate.merge_snapshots(
            aggregate.read_snapshots(
                metrics_dir, stale_s=stale_s, clock=clock
            )
        )
        out = {"queue_rows": 0.0, "shed_rate": 0.0, "slo_burning": False}
        hist = merged.histogram_total("dct_serve_queue_depth")
        if hist is not None:
            prev = state["q"]
            state["q"] = (hist["count"], hist["sum"])
            if prev is not None:
                d_count = hist["count"] - prev[0]
                d_sum = hist["sum"] - prev[1]
                if d_count > 0:
                    out["queue_rows"] = d_sum / d_count
        sheds = merged.total("dct_serve_shed_total")
        if sheds is not None:
            prev = state["sheds"]
            state["sheds"] = sheds
            if prev is not None:
                out["shed_rate"] = max(0.0, sheds - prev)
        return out

    return signal


def controller_publisher(registry, *, proc: str | None = None):
    """A metrics-plane snapshot publisher for the controller process
    (the pool parent has no serving registry of its own), or None when
    the plane is unarmed."""
    from dct_tpu_torch.config import ObservabilityConfig

    obs = ObservabilityConfig.from_env()
    if not obs.metrics_dir:
        return None
    from dct_tpu_torch.observability.aggregate import SnapshotPublisher

    return SnapshotPublisher(
        registry, obs.metrics_dir,
        proc=proc or f"serve-ctl-{os.getpid()}",
        interval_s=obs.metrics_publish_s,
    )
