"""Cross-process snapshot aggregation: the fleet half of the metrics
plane (a copy of ``dct_tpu/observability/aggregate.py``).

A scrape of one process sees one process's counts. The fix is a
shared-nothing snapshot protocol:

1. every participating process (the trainer's coordinator, the
   supervising launcher, the multi-tenant scheduler) periodically
   publishes its FULL
   :meth:`~dct_tpu_torch.observability.metrics.MetricsRegistry.snapshot`
   as one JSON file under ``DCT_METRICS_DIR`` -- written tmp-then-
   ``os.replace`` so a reader never sees a torn snapshot;
2. a reader (:func:`aggregate_text`) reads every sibling snapshot in the
   directory, drops the stale ones, and merges: counters and histogram
   buckets sum, gauges combine by their declared ``agg``, and every
   series is ALSO emitted per process under a ``proc`` label so
   operators can still see skew.

Staleness rules (the part that keeps restarts honest):

- a snapshot whose writing pid is **dead** is dropped unless it is
  marked ``final`` (a batch process's terminal snapshot — the textfile
  pattern: the trainer's numbers outlive the trainer);
- a live-process snapshot older than ``stale_s`` (wall-clock mtime) is
  dropped — a wedged worker must stop contributing yesterday's counts;
- an unparsable file is skipped (a concurrent writer crashed mid-tmp;
  the ``os.replace`` protocol makes this only possible for foreign
  debris).

Two snapshots from the same ``proc`` name keep the newest — a restarted
worker replaces, never double-counts, its predecessor.
"""

from __future__ import annotations

import json
import os
import threading
import time

from dct_tpu_torch.observability.prometheus import (
    HistogramAccumulator,
    MetricFamily,
    render,
)

#: Default seconds after which a live process's snapshot stops counting.
DEFAULT_STALE_S = 30.0


def snapshot_path(directory: str, proc: str) -> str:
    # proc names are platform-minted (serve-<pid>, rank0, launcher-<pid>)
    # but sanitize anyway: a path separator in a label must not escape
    # the snapshot dir.
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in proc)
    return os.path.join(directory, f"{safe}.metrics.json")


def write_snapshot(snapshot: dict, directory: str) -> str | None:
    """Atomically publish one snapshot dict; returns the path, or None
    when the write failed (telemetry never fails the caller)."""
    path = snapshot_path(directory, snapshot.get("proc", "proc"))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(directory, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(snapshot, f)
        os.replace(tmp, path)
    except (OSError, ValueError):
        return None
    return path


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        # EPERM and friends: the pid exists but is not ours.
        return True
    return True


def read_snapshots(
    directory: str,
    *,
    stale_s: float = DEFAULT_STALE_S,
    clock=time.time,
) -> list[dict]:
    """Every live sibling snapshot under ``directory`` (staleness rules
    in the module docstring), newest first per ``proc`` name."""
    out: dict[str, tuple[float, dict]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    now = clock()
    for name in names:
        if not name.endswith(".metrics.json"):
            continue
        path = os.path.join(directory, name)
        try:
            mtime = os.stat(path).st_mtime
            with open(path) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(snap, dict) or "metrics" not in snap:
            continue
        final = bool(snap.get("final"))
        pid = snap.get("pid")
        if not final:
            if isinstance(pid, int) and not _pid_alive(pid):
                continue
            if stale_s > 0 and now - mtime > stale_s:
                continue
        proc = str(snap.get("proc", name))
        kept = out.get(proc)
        if kept is None or mtime >= kept[0]:
            out[proc] = (mtime, snap)
    return [snap for _mt, snap in sorted(
        out.values(), key=lambda p: str(p[1].get("proc", ""))
    )]


# ----------------------------------------------------------------------
# merge


class MergedMetrics:
    """The fleet view: per-metric totals (the scrape's headline series)
    plus the per-process series preserved under a ``proc`` label.

    ``value(name, labels)`` / ``total(name)`` give the SLO layer its
    aggregated inputs without re-parsing exposition text.
    """

    def __init__(self):
        # name -> {"type", "help", "agg", "buckets",
        #          "totals": {label_key: value|hist-dict},
        #          "per_proc": {(proc, label_key): value|hist-dict}}
        self.metrics: dict[str, dict] = {}
        self.procs: list[str] = []

    # -- queries -------------------------------------------------------
    def value(self, name: str, labels: dict | None = None):
        m = self.metrics.get(name)
        if m is None:
            return None
        key = tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))
        return m["totals"].get(key)

    def total(self, name: str) -> float | None:
        """Sum of a counter/gauge family over ALL label sets (what the
        availability SLO wants: requests regardless of slot)."""
        m = self.metrics.get(name)
        if m is None or m["type"] == "histogram":
            return None
        vals = list(m["totals"].values())
        return float(sum(vals)) if vals else None

    def histogram_total(self, name: str) -> dict | None:
        """Bucket-wise sum of a histogram family over all label sets:
        ``{"buckets": [...], "counts": [...], "count": n, "sum": s}``."""
        m = self.metrics.get(name)
        if m is None or m["type"] != "histogram":
            return None
        agg = None
        for h in m["totals"].values():
            if agg is None:
                agg = {
                    "buckets": list(m["buckets"]),
                    "counts": list(h["counts"]),
                    "count": h["count"],
                    "sum": h["sum"],
                }
            else:
                agg["counts"] = [
                    a + b for a, b in zip(agg["counts"], h["counts"])
                ]
                agg["count"] += h["count"]
                agg["sum"] += h["sum"]
        return agg


def _merge_value(mtype: str, agg: str, old, new, old_ts, new_ts):
    if old is None:
        return new
    if mtype == "counter" or agg == "sum":
        return old + new
    if agg == "max":
        return max(old, new)
    if agg == "min":
        return min(old, new)
    # "last": the newest snapshot's value wins.
    return new if new_ts >= old_ts else old


def merge_snapshots(snapshots: list[dict]) -> MergedMetrics:
    """Merge per the metric-type semantics (module docstring). Metric
    families meeting under one name must agree on type and buckets;
    a disagreeing snapshot's family is skipped (one mis-published
    process must not corrupt the fleet view)."""
    out = MergedMetrics()
    ts_by_key: dict[tuple, float] = {}
    for snap in snapshots:
        proc = str(snap.get("proc", "?"))
        ts = float(snap.get("ts", 0.0))
        out.procs.append(proc)
        for m in snap.get("metrics", []):
            name = m.get("name")
            mtype = m.get("type")
            if not name or mtype not in ("counter", "gauge", "histogram"):
                continue
            agg = m.get("agg", "sum")
            ent = out.metrics.get(name)
            if ent is None:
                ent = out.metrics[name] = {
                    "type": mtype,
                    "help": m.get("help", ""),
                    "agg": agg,
                    "buckets": list(m.get("buckets") or []),
                    "totals": {},
                    "per_proc": {},
                }
            if ent["type"] != mtype or (
                mtype == "histogram"
                and ent["buckets"] != list(m.get("buckets") or [])
            ):
                continue
            for s in m.get("samples", []):
                key = tuple(sorted(
                    (str(k), str(v))
                    for k, v in (s.get("labels") or {}).items()
                ))
                if mtype == "histogram":
                    h = {
                        "counts": list(s.get("counts") or []),
                        "count": s.get("count", 0),
                        "sum": s.get("sum", 0.0),
                    }
                    if len(h["counts"]) != len(ent["buckets"]):
                        continue
                    tot = ent["totals"].get(key)
                    if tot is None:
                        ent["totals"][key] = {
                            "counts": list(h["counts"]),
                            "count": h["count"],
                            "sum": h["sum"],
                        }
                    else:
                        tot["counts"] = [
                            a + b for a, b in zip(tot["counts"], h["counts"])
                        ]
                        tot["count"] += h["count"]
                        tot["sum"] += h["sum"]
                    ent["per_proc"][(proc, key)] = h
                else:
                    v = float(s.get("value", 0.0))
                    tkey = (name,) + key
                    ent["totals"][key] = _merge_value(
                        mtype, agg, ent["totals"].get(key), v,
                        ts_by_key.get(tkey, 0.0), ts,
                    )
                    ts_by_key[tkey] = max(ts_by_key.get(tkey, 0.0), ts)
                    ent["per_proc"][(proc, key)] = v
    return out


def render_merged(merged: MergedMetrics, *, per_proc: bool = True) -> str:
    """Text exposition of the fleet view: totals first (no ``proc``
    label — dashboards keep their single-process queries), then every
    per-process series under ``proc`` when ``per_proc`` is set."""
    fams = []
    for name in sorted(merged.metrics):
        m = merged.metrics[name]
        fam = MetricFamily(name, m["type"], m["help"])
        rows = []
        for key, val in sorted(m["totals"].items()):
            rows.append((dict(key) or None, val))
        if per_proc:
            for (proc, key), val in sorted(m["per_proc"].items()):
                rows.append(({**dict(key), "proc": proc}, val))
        for labels, val in rows:
            if m["type"] == "histogram":
                acc = HistogramAccumulator(tuple(m["buckets"]))
                acc.counts = list(val["counts"])
                acc.count = val["count"]
                acc.sum = val["sum"]
                acc.samples_into(fam, labels)
            else:
                fam.add(val, labels)
        fams.append(fam)
    return render(fams) if fams else ""


def aggregate_text(
    directory: str,
    *,
    stale_s: float = DEFAULT_STALE_S,
    per_proc: bool = True,
    clock=time.time,
) -> tuple[str, MergedMetrics]:
    """One scrape's worth of work: read + merge + render. Returns the
    body and the merged view (the SLO layer consumes the latter)."""
    merged = merge_snapshots(
        read_snapshots(directory, stale_s=stale_s, clock=clock)
    )
    return render_merged(merged, per_proc=per_proc), merged


# ----------------------------------------------------------------------
# publisher


class SnapshotPublisher:
    """Per-process publishing loop: throttled on the hot path, kept
    fresh by a daemon timer when idle.

    ``maybe_publish()`` costs one clock read when inside the throttle
    window — cheap enough to ride every request completion. The timer
    thread republishes every ``interval_s`` so an idle-but-alive
    process never goes stale (staleness would drop its historical
    counts from the fleet totals). ``close(final=True)`` writes the
    terminal snapshot batch processes leave behind. The reference's
    publisher also appends every snapshot to the telemetry history store
    when ``DCT_TS_DIR`` arms it; that plane is ROADMAP Queue A item 27.
    """

    def __init__(
        self,
        registry,
        directory: str,
        *,
        proc: str,
        interval_s: float = 2.0,
        clock=time.time,
        start_timer: bool = True,
    ):
        self.registry = registry
        self.directory = directory
        self.proc = proc
        self.interval_s = max(0.0, float(interval_s))
        self._clock = clock
        self._last = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False
        self._thread = None
        if start_timer and self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name=f"dct-metrics-{proc}", daemon=True
            )
            self._thread.start()

    def publish(self, *, final: bool = False) -> str | None:
        with self._lock:
            if self._closed:
                # A publish landing after close() would resurrect a
                # retired snapshot (or clear a final one's flag).
                return None
            self._last = self._clock()
            snap = self.registry.snapshot(proc=self.proc, final=final)
            return write_snapshot(snap, self.directory)

    def maybe_publish(self) -> bool:
        """Publish if the throttle window elapsed; True when written."""
        if self._clock() - self._last < self.interval_s:
            return False
        return self.publish() is not None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s or 2.0):
            try:
                self.maybe_publish()
            except Exception:  # noqa: BLE001 — telemetry never kills a proc
                return

    def close(self, *, final: bool = False) -> None:
        """Stop the timer. ``final=True`` leaves a terminal snapshot
        behind (the batch-process textfile pattern); otherwise the
        snapshot is RETIRED (removed) — an in-process server that shut
        down cleanly has left the fleet, and its pid staying alive must
        not keep its counts contributing.

        The terminal write/remove happens under the publish lock with
        the closed flag already set, so an in-flight ``publish`` (timer
        thread, request path) can neither resurrect a retired snapshot
        nor overwrite a final one as non-final."""
        self._stop.set()
        with self._lock:
            self._closed = True
            try:
                if final:
                    snap = self.registry.snapshot(proc=self.proc, final=True)
                    write_snapshot(snap, self.directory)
                else:
                    os.remove(snapshot_path(self.directory, self.proc))
            except OSError:
                pass
