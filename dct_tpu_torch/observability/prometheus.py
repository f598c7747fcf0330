"""Prometheus text exposition (format 0.0.4), dependency-free (a copy of
``dct_tpu/observability/prometheus.py``).

The serving server's ``GET /metrics`` and the trainer's end-of-run dump
both speak the plain-text exposition format every Prometheus-compatible
scraper (Prometheus, VictoriaMetrics, Grafana Agent, promtool) parses::

    # HELP dct_requests_total Requests served per slot.
    # TYPE dct_requests_total counter
    dct_requests_total{slot="blue"} 42

Only the subset the platform needs is implemented: counter / gauge /
histogram families, label escaping per the spec (backslash, double
quote, newline), and ``+Inf`` bucket handling. No client library, no
registry singletons — families are built from plain data at render
time, which keeps the server handlers stateless over the metrics they
already hold.
"""

from __future__ import annotations

import math

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Default request-latency buckets (seconds) — sub-ms to 10 s, the span
#: from a cached numpy forward to a cold package load.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def format_value(value: float) -> str:
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class MetricFamily:
    """One named metric with HELP/TYPE lines and its samples.

    ``add(value, labels, suffix)`` appends a sample; histogram families
    use suffixes ``_bucket`` / ``_sum`` / ``_count`` (see
    :class:`HistogramAccumulator.samples_into`).
    """

    def __init__(self, name: str, mtype: str, help_text: str):
        if mtype not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unsupported metric type {mtype!r}")
        self.name = name
        self.mtype = mtype
        self.help_text = help_text
        self.samples: list[tuple[str, dict | None, float]] = []

    def add(
        self, value: float, labels: dict | None = None, suffix: str = ""
    ) -> "MetricFamily":
        self.samples.append((suffix, labels, value))
        return self

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help_text}",
            f"# TYPE {self.name} {self.mtype}",
        ]
        for suffix, labels, value in self.samples:
            lines.append(
                f"{self.name}{suffix}{format_labels(labels)} "
                f"{format_value(value)}"
            )
        return "\n".join(lines)


def render(families: list[MetricFamily]) -> str:
    """Full exposition body (trailing newline included, as scrapers
    expect)."""
    return "\n".join(f.render() for f in families) + "\n"


class HistogramAccumulator:
    """Cumulative-bucket histogram (the Prometheus layout: ``le``
    buckets are CUMULATIVE counts, plus ``_sum`` and ``_count``)."""

    def __init__(self, buckets: tuple[float, ...] = LATENCY_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        # counts[i] = observations <= buckets[i]; the +Inf bucket is
        # implicit (== count).
        self.counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, le in enumerate(self.buckets):
            if v <= le:
                for j in range(i, len(self.counts)):
                    self.counts[j] += 1
                break

    def samples_into(
        self, family: MetricFamily, labels: dict | None = None
    ) -> None:
        base = dict(labels or {})
        for le, c in zip(self.buckets, self.counts):
            family.add(c, {**base, "le": format_value(le)}, "_bucket")
        family.add(self.count, {**base, "le": "+Inf"}, "_bucket")
        family.add(self.sum, base or None, "_sum")
        family.add(self.count, base or None, "_count")
