"""The port's metrics plane (CPU) against the reference's.

- ``prometheus``: value and label formatting, histogram accumulation and
  rendered families byte-equal to the reference's.
- ``MetricsRegistry``: the same seeded sequence of counter, gauge and
  histogram updates renders the same exposition bytes and the same
  snapshot; registration conflicts raise the same errors.
- ``aggregate``: the same snapshot files (live, final, stale, dead-pid,
  a restarted proc, debris) read, merge and render byte-equal, with the
  same ``value`` / ``total`` / ``histogram_total`` answers; the publisher
  writes, retires and finalizes its snapshot as the reference's does.
- ``LiveTrainMetrics``: the same epoch records give the same snapshot;
  ``Trainer.fit`` publishes them when ``DCT_METRICS_DIR`` is set.
- The launcher's per-rank progress-age gauge and the supervisor's restart
  counters and lost-wall gauge reach the plane.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from dct_tpu.observability import aggregate as ref_agg
from dct_tpu.observability import dump as ref_dump
from dct_tpu.observability import metrics as ref_metrics
from dct_tpu.observability import prometheus as ref_prom
from dct_tpu_torch.observability import aggregate as agg
from dct_tpu_torch.observability import dump
from dct_tpu_torch.observability import metrics
from dct_tpu_torch.observability import prometheus as prom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------------
# Exposition format.


@pytest.mark.parametrize("value", [0, 1, -3, 2.5, 1e15, 1e16, 1 / 3,
                                   float("inf"), float("-inf"),
                                   float("nan"), 7.0, -0.0])
def test_format_value_matches_reference(value):
    assert prom.format_value(value) == ref_prom.format_value(value)


def test_labels_histogram_and_families_match_reference():
    labels = {"slot": 'b"l\\ue\n', "z": 1, "a": None}
    assert prom.format_labels(labels) == ref_prom.format_labels(labels)
    assert prom.format_labels({}) == ref_prom.format_labels({}) == ""
    rng = np.random.default_rng(0)
    obs = rng.exponential(0.3, 200).tolist() + [0.0, 10.0, 99.0]
    h, rh = prom.HistogramAccumulator(), ref_prom.HistogramAccumulator()
    for v in obs:
        h.observe(v)
        rh.observe(v)
    fam = prom.MetricFamily("dct_x_seconds", "histogram", "X.")
    rfam = ref_prom.MetricFamily("dct_x_seconds", "histogram", "X.")
    h.samples_into(fam, {"k": "v"})
    rh.samples_into(rfam, {"k": "v"})
    g = prom.MetricFamily("dct_g", "gauge", "G.").add(1.5, {"a": "b"})
    rg = ref_prom.MetricFamily("dct_g", "gauge", "G.").add(1.5, {"a": "b"})
    assert prom.render([fam, g]) == ref_prom.render([rfam, rg])
    with pytest.raises(ValueError, match="unsupported"):
        prom.MetricFamily("x", "summary", "")


# ----------------------------------------------------------------------
# The registry.


def _drive_registry(mod, seed):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry(clock=lambda: 1234.5)
    c = reg.counter("dct_requests_total", "Requests.")
    g_last = reg.gauge("dct_frac", "A fraction.", agg="last")
    g_max = reg.gauge("dct_age_seconds", "An age.", agg="max")
    h = reg.histogram("dct_wait_seconds", "Waits.",
                      buckets=(0.05, 0.25, 1.0, 5.0))
    for _ in range(150):
        lab = {"tenant": str(rng.choice(["a", "b", "c"])),
               "slot": str(rng.choice(["blue", "green"]))}
        op = rng.integers(0, 4)
        if op == 0:
            c.inc(float(rng.uniform(0, 3)), lab)
        elif op == 1:
            g_last.set(float(rng.uniform()), lab)
        elif op == 2:
            g_max.set(float(rng.uniform(0, 100)), {"rank": int(rng.integers(4))})
        else:
            h.observe(float(rng.exponential(1.0)), lab)
    # Idempotent constructors return the same families.
    reg.counter("dct_requests_total").inc(1)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_render_and_snapshot_match_reference(seed):
    reg, ref = _drive_registry(metrics, seed), _drive_registry(ref_metrics,
                                                               seed)
    assert reg.render() == ref.render()
    assert reg.snapshot(proc="p", final=True) == ref.snapshot(proc="p",
                                                              final=True)
    assert metrics.MetricsRegistry().render() == ""


def test_registry_conflicts_raise_as_reference():
    for mod in (metrics, ref_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("a")
        reg.gauge("g", agg="max")
        reg.histogram("h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="already registered as counter"):
            reg.gauge("a")
        with pytest.raises(ValueError, match="agg='max'"):
            reg.gauge("g", agg="sum")
        with pytest.raises(ValueError, match="different buckets"):
            reg.histogram("h", buckets=(1.0,))
        with pytest.raises(ValueError, match="unknown gauge agg"):
            reg.gauge("x", agg="mean")


# ----------------------------------------------------------------------
# Aggregation across processes.


def _snapshots_dir(tmp_path):
    """Snapshot files covering every staleness rule: live, final from a
    dead pid, live from a dead pid, stale by mtime, a restarted proc (two
    files, one proc name), a torn file and foreign debris."""
    d = tmp_path / "metrics"
    d.mkdir()
    dead = 2 ** 22 + 17  # no such pid

    def snap(proc, pid, ts, final=False, seed=0):
        reg = _drive_registry(ref_metrics, seed)
        s = reg.snapshot(proc=proc, final=final)
        s.update(pid=pid, ts=ts)
        return s

    files = {
        "serve-1.metrics.json": snap("serve-1", os.getpid(), 100.0, seed=1),
        "serve-2.metrics.json": snap("serve-2", os.getpid(), 101.0, seed=2),
        "train-rank0.metrics.json": snap("train-rank0", dead, 90.0,
                                         final=True, seed=3),
        "gone.metrics.json": snap("gone", dead, 95.0, seed=4),
        "old.metrics.json": snap("old", os.getpid(), 50.0, seed=5),
        "restart-a.metrics.json": snap("worker", os.getpid(), 80.0, seed=6),
        "restart-b.metrics.json": snap("worker", os.getpid(), 99.0, seed=7),
    }
    now = time.time()
    for name, s in files.items():
        (d / name).write_text(json.dumps(s))
    os.utime(d / "old.metrics.json", (now - 3600, now - 3600))
    os.utime(d / "restart-a.metrics.json", (now - 5, now - 5))
    (d / "torn.metrics.json").write_text('{"proc": "torn", "metr')
    (d / "notes.txt").write_text("not a snapshot")
    (d / "nometrics.metrics.json").write_text(json.dumps({"proc": "x"}))
    return str(d)


@pytest.mark.parametrize("per_proc", [True, False])
def test_read_merge_render_match_reference(tmp_path, per_proc):
    d = _snapshots_dir(tmp_path)
    got = agg.read_snapshots(d, stale_s=30.0)
    want = ref_agg.read_snapshots(d, stale_s=30.0)
    assert got == want
    assert [s["proc"] for s in got] == ["serve-1", "serve-2", "train-rank0",
                                        "worker"]
    body, merged = agg.aggregate_text(d, stale_s=30.0, per_proc=per_proc)
    rbody, rmerged = ref_agg.aggregate_text(d, stale_s=30.0,
                                            per_proc=per_proc)
    assert body == rbody and body
    assert merged.metrics == rmerged.metrics and merged.procs == rmerged.procs
    for name in ("dct_requests_total", "dct_frac", "dct_age_seconds",
                 "dct_wait_seconds"):
        assert merged.total(name) == rmerged.total(name)
        assert merged.histogram_total(name) == rmerged.histogram_total(name)
        assert merged.value(name, {"tenant": "a", "slot": "blue"}) == \
            rmerged.value(name, {"tenant": "a", "slot": "blue"})
    # A disagreeing family (another type under the same name) is skipped
    # by both.
    bad = _drive_registry(ref_metrics, 9).snapshot(proc="bad")
    for m in bad["metrics"]:
        if m["name"] == "dct_frac":
            m["type"] = "counter"
    snaps = want + [bad]
    assert agg.render_merged(agg.merge_snapshots(snaps)) == \
        ref_agg.render_merged(ref_agg.merge_snapshots(snaps))


def test_publisher_publishes_retires_and_finalizes_as_reference(tmp_path):
    for side, mod, mmod in (("port", agg, metrics),
                            ("ref", ref_agg, ref_metrics)):
        d = str(tmp_path / side)
        t = [100.0]
        reg = mmod.MetricsRegistry(clock=lambda: t[0])
        c = reg.counter("dct_n_total", "N.")
        kw = {} if side == "port" else {"history": None}
        pub = mod.SnapshotPublisher(reg, d, proc="p/1", interval_s=10.0,
                                    clock=lambda: t[0], start_timer=False,
                                    **kw)
        c.inc(1)
        assert pub.maybe_publish()          # first publish
        c.inc(1)
        assert not pub.maybe_publish()      # inside the throttle window
        t[0] += 10.0
        assert pub.maybe_publish()
        path = mod.snapshot_path(d, "p/1")
        assert os.path.basename(path) == "p_1.metrics.json"
        with open(path) as f:
            live = json.load(f)
        pub.close()                         # retire: the snapshot goes
        assert not os.path.exists(path)
        assert pub.publish() is None        # no resurrection after close
        pub2 = mod.SnapshotPublisher(reg, d, proc="p/1", interval_s=0,
                                     clock=lambda: t[0], start_timer=False,
                                     **kw)
        pub2.close(final=True)
        with open(path) as f:
            final = json.load(f)
        live.pop("pid")
        final.pop("pid")
        if side == "port":
            got = (live, final)
        else:
            assert got == (live, final)
    assert got[1]["final"] is True and got[0]["final"] is False


def test_publisher_timer_keeps_an_idle_process_fresh(tmp_path):
    reg = metrics.MetricsRegistry()
    reg.counter("dct_idle_total").inc(1)
    pub = agg.SnapshotPublisher(reg, str(tmp_path), proc="idle",
                                interval_s=0.05)
    path = agg.snapshot_path(str(tmp_path), "idle")
    deadline = time.time() + 10
    while time.time() < deadline and not os.path.exists(path):
        time.sleep(0.02)
    assert os.path.exists(path)
    pub.close(final=True)
    assert pub._thread is not None
    pub._thread.join(timeout=5)
    assert not pub._thread.is_alive()


# ----------------------------------------------------------------------
# Live training metrics.


class _Obs:
    def __init__(self, d, enabled=True):
        self.enabled, self.metrics_dir, self.metrics_publish_s = (
            enabled, d, 2.0)


def test_live_train_metrics_match_reference(tmp_path):
    records = [dict(val_loss=0.6, goodput_fraction=None,
                    samples_per_sec=1200.0, step_seconds=0.02,
                    grad_norm=1.5),
               dict(val_loss=float("nan"), samples_per_sec=1300.0,
                    step_seconds=0.019, grad_norm=float("inf")),
               dict(val_loss=0.5, goodput_fraction=0.8)]
    snaps = {}
    for side, mod in (("port", dump), ("ref", ref_dump)):
        live = mod.live_train_metrics(_Obs(str(tmp_path / side)),
                                      run_id="dct-x", rank=0)
        for rec in records:
            live.epoch_end(**rec)
        with open(agg.snapshot_path(str(tmp_path / side),
                                    "train-rank0")) as f:
            snap = json.load(f)
        live.close()
        assert not os.listdir(tmp_path / side)  # retired
        snap.pop("pid")
        snap.pop("ts")
        snaps[side] = snap
        assert mod.live_train_metrics(_Obs("x"), run_id="r", rank=1) is None
        assert mod.live_train_metrics(_Obs(""), run_id="r", rank=0) is None
        assert mod.live_train_metrics(_Obs("x", enabled=False), run_id="r",
                                      rank=0) is None
    assert snaps["port"] == snaps["ref"]


def test_trainer_publishes_live_epoch_metrics(tmp_path, monkeypatch):
    from dct_tpu_torch.config import (
        DataConfig,
        ObservabilityConfig,
        RunConfig,
        TrainConfig,
    )
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.train.trainer import Trainer

    generate_weather_csv(str(tmp_path / "raw.csv"), rows=400, seed=2)
    preprocess_csv_to_parquet(str(tmp_path / "raw.csv"),
                              str(tmp_path / "p"))
    monkeypatch.setenv("DCT_TRACKING_DIR", str(tmp_path / "mlruns"))
    kept = {}
    monkeypatch.setattr(dump.LiveTrainMetrics, "close",
                        lambda self: kept.setdefault("live", self))
    cfg = RunConfig(
        data=DataConfig(processed_dir=str(tmp_path / "p"),
                        models_dir=str(tmp_path / "m")),
        train=TrainConfig(epochs=3),
        obs=ObservabilityConfig(events_dir=str(tmp_path / "ev"),
                                heartbeat_dir=str(tmp_path / "hb"),
                                metrics_dir=str(tmp_path / "metrics"),
                                run_id="dct-live"))
    result = Trainer(cfg, device="cpu").fit()
    _, merged = agg.aggregate_text(str(tmp_path / "metrics"), stale_s=0)
    lab = {"run_id": "dct-live"}
    assert merged.value("dct_train_epochs_total", lab) == 3
    assert merged.value("dct_train_val_loss", lab) == pytest.approx(
        result.val_loss)
    assert merged.value("dct_train_samples_per_sec", lab) > 0
    assert merged.value("dct_train_step_seconds", lab) > 0
    assert merged.value("dct_train_grad_norm", lab) > 0
    assert merged.value("dct_train_goodput_fraction", lab) is None
    assert "live" in kept  # fit closed it


# ----------------------------------------------------------------------
# The launcher's and the supervisor's metrics.


def _launcher_env(tmp_path, **extra):
    return {"DCT_EVENTS_DIR": str(tmp_path / "events"),
            "DCT_HEARTBEAT_DIR": str(tmp_path / "hb"), "DCT_RUN_ID": "",
            "DCT_METRICS_DIR": str(tmp_path / "metrics"),
            "DCT_METRICS_PUBLISH_S": "0.05", "PYTHONPATH": REPO, **extra}


def test_launcher_publishes_progress_age_while_ranks_run(tmp_path):
    from dct_tpu_torch.launch.launcher import LocalProcessLauncher

    code = ("import os, time\n"
            "from dct_tpu_torch.observability.heartbeat import "
            "HeartbeatWriter\n"
            "w = HeartbeatWriter(os.environ['DCT_HEARTBEAT_DIR'], 0, "
            "run_id=os.environ['DCT_RUN_ID'], min_interval=0)\n"
            "w.beat(step=1, epoch=0, phase='train', force=True)\n"
            "time.sleep(2.0)\n")
    seen = {}

    def scrape():
        deadline = time.time() + 30
        while time.time() < deadline and "age" not in seen:
            _, merged = agg.aggregate_text(str(tmp_path / "metrics"),
                                           stale_s=0)
            age = merged.value("dct_rank_progress_age_seconds",
                               {"rank": "0"})
            if age is not None:
                seen["age"] = age
            time.sleep(0.05)

    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    lch = LocalProcessLauncher(stagger_seconds=0.0, timeout=60.0,
                               poll_seconds=0.05, heartbeat_scan_seconds=0.1)
    res = lch.launch([sys.executable, "-c", code], world_size=1,
                     env=_launcher_env(tmp_path))
    t.join(timeout=35)
    assert not t.is_alive()
    assert [r.returncode for r in res] == [0]
    assert 0 <= seen["age"] < 30
    # A live signal: the launcher retired its snapshot at the end.
    assert not [n for n in os.listdir(tmp_path / "metrics")
                if n.startswith("launcher-")]


def test_supervisor_publishes_restart_counters_and_lost_wall(tmp_path):
    from dct_tpu_torch.launch.launcher import LocalProcessLauncher

    marker = tmp_path / "crashed"
    code = ("import os, sys\n"
            f"m = {str(marker)!r}\n"
            "if not os.path.exists(m):\n"
            "    open(m, 'w').close(); sys.exit(117)\n")
    res = LocalProcessLauncher(stagger_seconds=0.0, timeout=60.0,
                               poll_seconds=0.05).supervise(
        [sys.executable, "-c", code], world_size=1,
        env=_launcher_env(tmp_path), backoff_s=0.05, jitter=0.0)
    assert res.success and res.restarts == 1
    _, merged = agg.aggregate_text(str(tmp_path / "metrics"), stale_s=0)
    assert merged.value("dct_restarts_total",
                        {"classification": "crash"}) == 1
    assert merged.value("dct_restart_lost_wall_seconds") > 0
    snaps = agg.read_snapshots(str(tmp_path / "metrics"), stale_s=0)
    assert [s["final"] for s in snaps
            if s["proc"].startswith("supervisor-")] == [True]
