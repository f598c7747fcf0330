"""MetricsRegistry: the process-local half of the platform metrics plane
(a copy of ``dct_tpu/observability/metrics.py``).

A common in-memory shape for metric state, so that processes can merge
their metrics:

- **counter** — monotone; merges across processes by SUM.
- **gauge** — last-written value; each gauge declares its merge
  semantics (``sum`` / ``max`` / ``min`` / ``last``) because "sum"
  is wrong for a fraction and "last" is wrong for a debt total.
- **histogram** — Prometheus cumulative-bucket layout
  (:class:`~dct_tpu_torch.observability.prometheus.HistogramAccumulator`);
  merges bucket-wise by SUM (valid because bucket boundaries are part
  of the metric identity — a mismatch is a hard error, not a quiet
  wrong answer).

Every metric is a family of label-keyed series (labels are sorted into
a canonical tuple, so ``{a,b}`` and ``{b,a}`` are one series). The
registry is thread-safe under one lock; ``snapshot()`` returns a plain
JSON-able dict (the wire format the aggregation layer publishes —
:mod:`dct_tpu_torch.observability.aggregate`) and ``render()`` returns the
0.0.4 text exposition of the local state.

Telemetry never fails the caller: metric mutation raises only on
programmer errors (unknown type, re-registration under a different
type), never on values.
"""

from __future__ import annotations

import threading
import time

from dct_tpu_torch.observability.prometheus import (
    LATENCY_BUCKETS,
    HistogramAccumulator,
    MetricFamily,
    render,
)

#: Gauge merge semantics the aggregation layer understands.
GAUGE_AGGS = ("sum", "max", "min", "last")


def _label_key(labels: dict | None) -> tuple:
    """Canonical series key: sorted (name, value-as-str) pairs."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """One named family inside a registry (internal; callers go through
    the registry's ``counter``/``gauge``/``histogram`` constructors)."""

    __slots__ = ("name", "mtype", "help_text", "agg", "buckets", "series")

    def __init__(self, name, mtype, help_text, *, agg="sum",
                 buckets=LATENCY_BUCKETS):
        self.name = name
        self.mtype = mtype
        self.help_text = help_text
        self.agg = agg
        self.buckets = tuple(sorted(buckets)) if mtype == "histogram" else None
        # label key tuple -> float (counter/gauge) | HistogramAccumulator
        self.series: dict = {}


class Counter:
    def __init__(self, registry: "MetricsRegistry", metric: _Metric):
        self._r = registry
        self._m = metric

    def inc(self, amount: float = 1.0, labels: dict | None = None) -> None:
        key = _label_key(labels)
        with self._r._lock:
            self._m.series[key] = (
                self._m.series.get(key, 0.0) + float(amount)
            )


class Gauge:
    def __init__(self, registry: "MetricsRegistry", metric: _Metric):
        self._r = registry
        self._m = metric

    def set(self, value: float, labels: dict | None = None) -> None:
        with self._r._lock:
            self._m.series[_label_key(labels)] = float(value)


class Histogram:
    def __init__(self, registry: "MetricsRegistry", metric: _Metric):
        self._r = registry
        self._m = metric

    def observe(self, value: float, labels: dict | None = None) -> None:
        key = _label_key(labels)
        with self._r._lock:
            acc = self._m.series.get(key)
            if acc is None:
                acc = self._m.series[key] = HistogramAccumulator(
                    self._m.buckets
                )
            acc.observe(value)

    def accumulator(self, labels: dict | None = None) -> HistogramAccumulator:
        """The live accumulator behind one label set (created on first
        access) — a READ handle for callers that inspect counts
        directly (tests, diagnostics). Mutate through :meth:`observe`
        only: writes outside the registry lock could be snapshotted
        torn (non-monotone cumulative counts mid-increment)."""
        key = _label_key(labels)
        with self._r._lock:
            acc = self._m.series.get(key)
            if acc is None:
                acc = self._m.series[key] = HistogramAccumulator(
                    self._m.buckets
                )
            return acc


class MetricsRegistry:
    """Thread-safe metric store for ONE process of the platform.

    Constructors are idempotent (a second ``counter(name)`` returns a
    handle to the same family) but type/agg/bucket conflicts raise —
    two callers silently disagreeing about a metric's shape is exactly
    the aggregation bug this module exists to prevent.
    """

    def __init__(self, *, clock=time.time):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._clock = clock

    # -- constructors --------------------------------------------------
    def _register(self, name, mtype, help_text, *, agg="sum",
                  buckets=LATENCY_BUCKETS) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = _Metric(
                    name, mtype, help_text, agg=agg, buckets=buckets
                )
                return m
            if m.mtype != mtype:
                raise ValueError(
                    f"metric {name!r} already registered as {m.mtype}"
                )
            if mtype == "gauge" and m.agg != agg:
                raise ValueError(
                    f"gauge {name!r} already registered with agg={m.agg!r}"
                )
            if mtype == "histogram" and m.buckets != tuple(sorted(buckets)):
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    "different buckets"
                )
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return Counter(self, self._register(name, "counter", help_text))

    def gauge(self, name: str, help_text: str = "",
              agg: str = "last") -> Gauge:
        if agg not in GAUGE_AGGS:
            raise ValueError(f"unknown gauge agg {agg!r}; known: {GAUGE_AGGS}")
        return Gauge(self, self._register(name, "gauge", help_text, agg=agg))

    def histogram(self, name: str, help_text: str = "",
                  buckets: tuple = LATENCY_BUCKETS) -> Histogram:
        return Histogram(
            self, self._register(name, "histogram", help_text,
                                 buckets=buckets)
        )

    # -- export --------------------------------------------------------
    def snapshot(self, *, proc: str, final: bool = False) -> dict:
        """The process's full metric state as one JSON-able dict — the
        wire format :mod:`~dct_tpu_torch.observability.aggregate` publishes.
        ``final=True`` marks a terminal snapshot (batch process about to
        exit: the textfile pattern) which the staleness rules keep even
        after the pid dies."""
        import os

        with self._lock:
            metrics = []
            for m in self._metrics.values():
                entry = {
                    "name": m.name,
                    "type": m.mtype,
                    "help": m.help_text,
                }
                if m.mtype == "gauge":
                    entry["agg"] = m.agg
                if m.mtype == "histogram":
                    entry["buckets"] = list(m.buckets)
                    entry["samples"] = [
                        {
                            "labels": dict(key),
                            "counts": list(acc.counts),
                            "count": acc.count,
                            "sum": acc.sum,
                        }
                        for key, acc in m.series.items()
                    ]
                else:
                    entry["samples"] = [
                        {"labels": dict(key), "value": v}
                        for key, v in m.series.items()
                    ]
                metrics.append(entry)
        return {
            "proc": proc,
            "pid": os.getpid(),
            "ts": round(self._clock(), 6),
            "final": bool(final),
            "metrics": metrics,
        }

    def families(self) -> list[MetricFamily]:
        """The local state as renderable families (no ``proc`` label —
        that is the aggregation layer's job)."""
        with self._lock:
            fams = []
            for m in self._metrics.values():
                fam = MetricFamily(m.name, m.mtype, m.help_text)
                for key, v in m.series.items():
                    labels = dict(key) or None
                    if m.mtype == "histogram":
                        v.samples_into(fam, labels)
                    else:
                        fam.add(v, labels)
                fams.append(fam)
            return fams

    def render(self) -> str:
        """Local-process text exposition (0.0.4)."""
        fams = self.families()
        return render(fams) if fams else ""
