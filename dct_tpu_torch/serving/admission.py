"""Priority admission control: overload degrades to bounded p99, not
collapse (copied whole from ``dct_tpu/serving/admission.py``).

Past the saturation knee a queue-everything server converts every extra
arrival into queue wait for ALL traffic: p99 grows without bound while
throughput stays flat (the collapse the loadgen measures past the
knee). The fix is an old one — admit what you can serve inside the
latency budget, shed the rest FAST. A shed request costs the client one
jittered backoff (cheap, explicit, retryable); an admitted request keeps
a bounded queue ahead of it, so its p99 stays a function of the budget
instead of the overload magnitude.

Mechanics (consulted by both HTTP handler modes before enqueueing to
the :class:`~dct_tpu_torch.serving.batching.MicroBatcher`):

- **Priority classes** ``high`` / ``normal`` / ``low``, read from the
  request header named by ``DCT_SERVE_PRIORITY_HEADER`` (default
  ``x-dct-priority``; unknown/absent = ``normal``). Each class owns a
  FRACTION of the queue budget: low sheds first, normal next, high
  only at the hard cap — so during overload the queue drains toward
  the traffic the operator declared most valuable.
- **Queue budget** in rows (``DCT_SERVE_ADMIT_MAX_QUEUE``) and a
  **queue-wait budget** (``DCT_SERVE_ADMIT_WAIT_MS``) estimated from
  the batcher's recent service rate — depth catches burst overload
  before the rate window sees it, the wait estimate catches a SLOWED
  server (degraded capacity at normal depth).
- **Deadline awareness**: a request carrying ``x-dct-deadline-ms``
  is shed — whatever its class — when the queue-wait estimate already
  exceeds its deadline: serving it late is work the client will
  discard.
- **Shed shape**: HTTP 429 with a ``Retry-After`` whose value is
  backoff-shaped by the retry policy (:class:`Retrier.delay`:
  exponential in the class's consecutive-shed run, jittered so a
  synchronized client herd de-synchronizes) — overload pushes retries
  OUT instead of inviting an immediate second wave.

Evidence: ``dct_serve_admitted_total{class}`` /
``dct_serve_shed_total{class}`` counters on the serving registry (so
they aggregate fleet-wide on one ``/metrics`` scrape), and throttled
``admission.shed`` events — one per class per
:attr:`~AdmissionController.event_interval_s`, carrying the shed count
since the last record, never a per-request disk append on the overload
hot path.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from dct_tpu_torch.resilience.retry import Retrier

#: Priority classes, most-valuable first, with the fraction of the
#: queue/wait budget each may fill before it sheds.
CLASS_BUDGET_FRACTIONS = {"high": 1.0, "normal": 0.8, "low": 0.5}

#: Request header naming the caller's latency deadline (milliseconds).
DEADLINE_HEADER = "x-dct-deadline-ms"


@dataclass
class AdmissionDecision:
    admitted: bool
    cls: str = "normal"
    reason: str = ""
    retry_after_s: float = 0.0
    queue_rows: int = 0
    est_wait_ms: float | None = None


class AdmissionController:
    """Per-server admission gate (thread-safe; one instance per server
    object, shared by every handler thread)."""

    def __init__(
        self,
        *,
        max_queue_rows: int = 256,
        wait_budget_ms: float = 500.0,
        priority_header: str = "x-dct-priority",
        retry_after_s: float = 0.25,
        retrier: Retrier | None = None,
        metrics_registry=None,
        emit=None,
        event_interval_s: float = 1.0,
        clock=time.monotonic,
    ):
        self.max_queue_rows = max(1, int(max_queue_rows))
        self.wait_budget_s = max(0.0, float(wait_budget_ms)) / 1e3
        self.priority_header = str(priority_header).lower()
        self.event_interval_s = float(event_interval_s)
        # Retry-After shaping: the retry policy's delay curve over
        # the class's consecutive-shed run (capped — a long overload
        # should not push Retry-After to minutes).
        self._retrier = retrier or Retrier(
            backoff_s=max(0.01, float(retry_after_s)), jitter=0.25
        )
        self._emit = emit
        self._clock = clock
        self._lock = threading.Lock()
        # class -> consecutive sheds (resets on an admit of that class)
        self._shed_run: dict[str, int] = {}
        self._lifetime_sheds = 0
        # class -> (sheds since last event, last event time)
        self._event_acc: dict[str, list] = {}
        self._admitted = self._shed = None
        if metrics_registry is not None:
            self._admitted = metrics_registry.counter(
                "dct_serve_admitted_total",
                "Requests admitted past admission control, by priority "
                "class.",
            )
            self._shed = metrics_registry.counter(
                "dct_serve_shed_total",
                "Requests shed (429) by admission control, by priority "
                "class.",
            )

    @classmethod
    def from_config(cls, serving, *, metrics_registry=None, emit=None):
        """Controller from a :class:`~dct_tpu_torch.config.ServingConfig`."""
        return cls(
            max_queue_rows=serving.admit_max_queue,
            wait_budget_ms=serving.admit_wait_ms,
            priority_header=serving.priority_header,
            retry_after_s=serving.retry_after_s,
            metrics_registry=metrics_registry,
            emit=emit,
        )

    # -- request side ---------------------------------------------------

    def parse_class(self, headers) -> str:
        raw = (headers.get(self.priority_header) or "").strip().lower()
        return raw if raw in CLASS_BUDGET_FRACTIONS else "normal"

    def parse_deadline_s(self, headers) -> float | None:
        raw = (headers.get(DEADLINE_HEADER) or "").strip()
        try:
            ms = float(raw)
        except ValueError:
            return None
        return ms / 1e3 if ms > 0 else None

    def decide(
        self,
        cls: str,
        queue_rows: int,
        est_wait_s: float | None,
        *,
        deadline_s: float | None = None,
    ) -> AdmissionDecision:
        """One admission decision; mutates counters/shed-runs and may
        emit a throttled ``admission.shed`` event."""
        frac = CLASS_BUDGET_FRACTIONS.get(cls, 0.8)
        reason = ""
        if queue_rows >= self.max_queue_rows * frac:
            reason = "queue_depth"
        elif (
            est_wait_s is not None
            and self.wait_budget_s > 0
            and est_wait_s > self.wait_budget_s * frac
        ):
            reason = "queue_wait"
        elif (
            deadline_s is not None
            and est_wait_s is not None
            and est_wait_s > deadline_s
        ):
            # The caller's own deadline is tighter than our budget:
            # admitting work the client will discard starves live work.
            reason = "deadline"
        wait_ms = (
            round(est_wait_s * 1e3, 3) if est_wait_s is not None else None
        )
        if not reason:
            with self._lock:
                self._shed_run[cls] = 0
            if self._admitted is not None:
                self._admitted.inc(1.0, {"class": cls})
            return AdmissionDecision(
                True, cls=cls, queue_rows=queue_rows, est_wait_ms=wait_ms
            )
        with self._lock:
            run = self._shed_run.get(cls, 0) + 1
            self._shed_run[cls] = run
            self._lifetime_sheds += 1
        retry_after = self._retrier.delay(min(run, 6))
        if self._shed is not None:
            self._shed.inc(1.0, {"class": cls})
        self._maybe_emit(cls, reason, queue_rows, wait_ms, retry_after)
        return AdmissionDecision(
            False, cls=cls, reason=reason, retry_after_s=retry_after,
            queue_rows=queue_rows, est_wait_ms=wait_ms,
        )

    def _maybe_emit(self, cls, reason, queue_rows, wait_ms, retry_after):
        """Throttled shed evidence: the first shed of an episode lands
        immediately, then one record per ``event_interval_s`` per class
        carrying the count since the last — never per-request appends."""
        if self._emit is None:
            return
        now = self._clock()
        with self._lock:
            acc = self._event_acc.setdefault(cls, [0, None])
            acc[0] += 1
            if acc[1] is not None and now - acc[1] < self.event_interval_s:
                return
            count, acc[0], acc[1] = acc[0], 0, now
        try:
            self._emit(
                "admission", "admission.shed",
                priority=cls, reason=reason, count=count,
                queue_rows=queue_rows, est_wait_ms=wait_ms,
                retry_after_s=round(retry_after, 3),
            )
        except Exception:  # noqa: BLE001 — telemetry never fails a shed
            pass

    def shed_counts(self) -> dict:
        """Un-emitted shed counts per class (tests/diagnostics)."""
        with self._lock:
            return {k: v[0] for k, v in self._event_acc.items()}

    def shed_total(self) -> float:
        """Lifetime sheds across every class — the autoscaler's
        shed-rate signal (delta between polls). Counted locally so the
        signal works with or without a metrics registry attached."""
        with self._lock:
            return float(self._lifetime_sheds)
