"""The port's multi-tenant scheduler (CPU) against the reference's.

- The tenant grammar: the same rosters parse to the same specs, and the
  reference's bad rosters are refused with the same messages.
- The quota ledger: a seeded script of register / grant / release calls
  gives the same ``pick``, ``deficit``, ``fair_share``,
  ``preemption_victim`` and ``report`` at every step.
- ``WorkloadScheduler``: both packages' schedulers, driven by the same
  scripted fake loops (each package's ``AlwaysOnLoop`` monkeypatched) and
  the same scripted clock, grant the same leases in the same order, book
  the same releases, and publish the same quota account on the metrics
  plane; the starvation-preemption check names the same victims.
- Real sessions on the CPU (``weather_mlp``, a few hundred rows): two
  inline tenants isolated from each other with the ledger on one
  aggregated scrape; a high-priority tenant preempting a running
  low-priority inline round; a broken tenant parked while its peer runs;
  a supervised round revoked (the world exits 75, ``supervise_preempted``,
  no relaunch) and resumed; ``scheduler_job``'s exit codes 0, 1 and 2.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import dct_tpu.continuous.loop as ref_loop_mod
import dct_tpu.scheduler as ref_sched
from dct_tpu.config import RunConfig as RefRunConfig
from dct_tpu.config import ObservabilityConfig as RefObsConfig
from dct_tpu.config import SchedulerConfig as RefSchedConfig
import dct_tpu_torch.continuous.loop as port_loop_mod
import dct_tpu_torch.scheduler as port_sched
from dct_tpu_torch.config import (
    DataConfig,
    LoopConfig,
    ObservabilityConfig,
    RunConfig,
    SchedulerConfig,
)
from dct_tpu_torch.data.synthetic import generate_weather_csv
from dct_tpu_torch.observability.aggregate import aggregate_text
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(path, *names):
    try:
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    except OSError:
        return []
    return [r for r in recs if not names or r.get("event") in names]


def _tenant_events(root, name, *names):
    return _events(os.path.join(root, name, "events", "events.jsonl"), *names)


def _sched_events(events_dir, *names):
    return _events(os.path.join(events_dir, "events.jsonl"), *names)


# ----------------------------------------------------------------------
# The tenant grammar.

GOOD_ROSTERS = [
    json.dumps([
        {"name": "alpha", "family": "weather_mlp", "weight": 2,
         "priority": "HIGH", "env": {"DCT_LR": "0.005"}},
        {"name": "beta"},
    ]),
    json.dumps({"tenants": [{"name": "a-1", "weight": "0.5",
                             "priority": " low ", "endpoint": "ep"}]}),
    json.dumps([{"name": "x", "env": {"DCT_FAULT_SPEC": "crash@rank0:epoch1",
                                      "DCT_WORLD_SIZE": 2}}]),
]

# The reference's bad rosters (tests/test_scheduler.py), plus two more.
BAD_ROSTERS = [
    "",
    "[]",
    "{notjson",
    '[{"name": "x y"}]',
    '[{"name": "a"}, {"name": "a"}]',
    '[{"name": "a", "weight": 0}]',
    '[{"name": "a", "weight": "heavy"}]',
    '[{"name": "a", "priority": "urgent"}]',
    '[{"name": "a", "unknown_field": 1}]',
    '[{"name": "a", "env": {"DCT_RUN_ID": "x"}}]',
    '[{"name": "a", "env": {"DCT_SCHED_ROOT": "x"}}]',
    '[{"name": "a", "env": {"DCT_MODELS_DIR": "x"}}]',
    '[{"name": "a", "env": {"PATH": "x"}}]',
    '[{"name": "a", "family": "m", "env": {"DCT_MODEL": "n"}}]',
    "/nonexistent/tenants.json",
    '[{"name": "a", "weight": "nan"}]',
    '{"tenants": [{"name": "a", "endpoint": ""}]}',
]


def _spec_fields(s):
    return (s.name, s.family, s.weight, s.priority, s.env, s.endpoint,
            s.priority_rank, s.resolved_endpoint())


@pytest.mark.parametrize("raw", GOOD_ROSTERS)
def test_parse_tenants_matches_reference(raw, tmp_path):
    got = port_sched.parse_tenants(raw)
    want = ref_sched.parse_tenants(raw)
    assert [_spec_fields(s) for s in got] == [_spec_fields(s) for s in want]
    path = tmp_path / "tenants.json"
    path.write_text(raw)
    assert ([_spec_fields(s) for s in port_sched.parse_tenants(str(path))]
            == [_spec_fields(s) for s in want])


@pytest.mark.parametrize("raw", BAD_ROSTERS)
def test_parse_tenants_rejects_as_reference(raw):
    with pytest.raises(ref_sched.TenantSpecError) as ref_err:
        ref_sched.parse_tenants(raw)
    with pytest.raises(port_sched.TenantSpecError) as port_err:
        port_sched.parse_tenants(raw)
    assert str(port_err.value) == str(ref_err.value)


def test_run_config_sched_from_env_matches_reference(monkeypatch):
    monkeypatch.setenv("DCT_TENANTS", '[{"name":"a"}]')
    monkeypatch.setenv("DCT_SCHED_ROOT", "/tmp/t")
    monkeypatch.setenv("DCT_SCHED_CONCURRENT", "0")  # clamped to 1
    monkeypatch.setenv("DCT_SCHED_PREEMPT_WAIT_S", "1.5")
    monkeypatch.setenv("DCT_SCHED_SHARED_CACHE", "0")
    monkeypatch.setenv("DCT_SCHED_MAX_ROUNDS", "7")
    got, want = RunConfig.from_env().sched, RefRunConfig.from_env().sched
    assert vars(got) == vars(want)
    assert got.concurrent == 1 and got.shared_cache is False


# ----------------------------------------------------------------------
# The quota ledger: a seeded script against the reference's.


def _ledger_script(ledger_cls, seed):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(5)]
    led = ledger_cls()
    for n in names:
        led.register(n, weight=float(rng.choice([0.5, 1.0, 2.0, 3.0])),
                     priority_rank=int(rng.integers(0, 3)),
                     chips=int(rng.integers(1, 3)))
    trace = []
    for _ in range(120):
        op = rng.integers(0, 3)
        name = names[int(rng.integers(0, 5))]
        if op == 0:
            led.record_grant(name, float(rng.uniform(-1.0, 30.0)))
        elif op == 1:
            good = (None if rng.random() < 0.3
                    else float(rng.uniform(-1.0, 40.0)))
            trace.append(led.record_release(
                name, wall_s=float(rng.uniform(0.0, 30.0)), goodput_s=good,
                preempted=bool(rng.random() < 0.2)))
        mask = rng.random(5) < 0.5
        subset = [n for n, m in zip(names, mask) if m]
        trace.append(led.pick(subset))
        trace.append(led.preemption_victim(name, subset))
        trace.append([led.deficit(n) for n in names])
        trace.append([led.fair_share(n, subset or None) for n in names])
        trace.append(led.report())
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quota_ledger_script_matches_reference(seed):
    got = _ledger_script(port_sched.QuotaLedger, seed)
    want = _ledger_script(ref_sched.QuotaLedger, seed)
    assert got == want


# ----------------------------------------------------------------------
# Both schedulers under the same scripted fake loops and clock.


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _FakeLoop:
    """Stands in for each package's AlwaysOnLoop: gate, one scripted
    round (the shared clock advances by its wall), release, until its
    walls run out. It holds the scheduler's condition (an RLock) from its
    release to its next gate, so the grant order is the policy's alone."""

    walls: dict = {}
    cond = None
    clock = None

    def __init__(self, cfg, *, round_gate, on_round, **_):
        self.name = cfg.loop.endpoint
        self._gate, self._on_round = round_gate, on_round
        self._stop = threading.Event()

    @property
    def stopping(self):
        return self._stop.is_set()

    def request_stop(self, reason="requested"):
        self._stop.set()

    def preempt_round(self):
        pass

    def run(self):
        walls = list(type(self).walls[self.name])
        rounds = 0
        with type(self).cond:
            while walls and self._gate():
                wall = walls.pop(0)
                type(self).clock.advance(wall)
                rounds += 1
                self._on_round({"mode": "inline",
                                "goodput_s": round(0.75 * wall, 4)})
        return {"reason": "max_rounds", "error": None, "rounds": rounds,
                "promotions": 0, "held": 0}


def _scripted_session(pkg, cfg, tenants, walls, **kw):
    clock = _Clock()
    sched = pkg.WorkloadScheduler(cfg, tenants=tenants, clock=clock, **kw)
    _FakeLoop.walls, _FakeLoop.cond, _FakeLoop.clock = walls, sched._cond, clock
    # No grant until every tenant waits: the first lease then goes to the
    # policy's pick, not to the first thread that reaches the gate.
    sched.sched_cfg.concurrent = 0

    def open_gate():
        deadline = time.time() + 30
        while time.time() < deadline:
            with sched._cond:
                rts = list(sched._runtimes.values())
                if len(rts) == len(tenants) and all(
                        rt.state == "waiting" for rt in rts):
                    sched.sched_cfg.concurrent = 1
                    sched._cond.notify_all()
                    return
            time.sleep(0.01)

    opener = threading.Thread(target=open_gate, daemon=True)
    opener.start()
    summary = sched.run()
    opener.join(timeout=5)
    assert not opener.is_alive()
    return sched, summary


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "run_id")}


@pytest.mark.parametrize("seed", [0, 1])
def test_grant_sequence_matches_reference(seed, tmp_path, monkeypatch):
    rng = np.random.default_rng(seed)
    roster = json.dumps([
        {"name": "alpha", "weight": 1.0},
        {"name": "beta", "weight": 3.0},
        {"name": "gamma", "weight": 2.0, "priority": "low"},
        {"name": "hot", "priority": "high"},
    ])
    walls = {n: [round(float(w), 3) for w in rng.uniform(0.5, 9.0, k)]
             for n, k in (("alpha", 5), ("beta", 7), ("gamma", 3),
                          ("hot", 2))}
    monkeypatch.setattr(port_loop_mod, "AlwaysOnLoop", _FakeLoop)
    monkeypatch.setattr(ref_loop_mod, "AlwaysOnLoop", _FakeLoop)
    out = {}
    for side, pkg, obs_cls, sched_cls, run_cls in (
            ("port", port_sched, ObservabilityConfig, SchedulerConfig,
             RunConfig),
            ("ref", ref_sched, RefObsConfig, RefSchedConfig, RefRunConfig)):
        base = tmp_path / side
        cfg = run_cls(
            obs=obs_cls(events_dir=str(base / "events"),
                        heartbeat_dir=str(base / "hb"),
                        metrics_dir=str(base / "metrics"), run_id="dct-t"),
            sched=sched_cls(root=str(base / "tenants"), poll_s=0.05))
        kw = {"device": "cpu"} if side == "port" else {}
        _, summary = _scripted_session(
            pkg, cfg, pkg.parse_tenants(roster), walls, **kw)
        # Grants and releases in order; a tenant's stop lands between
        # other tenants' grants as its thread finishes, so stops are
        # compared by tenant.
        events = [_strip(e) for e in _sched_events(
            str(base / "events"), "sched.grant", "sched.release")]
        events += sorted((_strip(e) for e in _sched_events(
            str(base / "events"), "tenant.stop", "sched.stop")),
            key=lambda e: (e["event"], e.get("tenant") or ""))
        _, merged = aggregate_text(str(base / "metrics"), stale_s=0)
        totals = {name: m["totals"] for name, m in merged.metrics.items()}
        out[side] = (summary, events, totals)
    (got, got_ev, got_m), (want, want_ev, want_m) = out["port"], out["ref"]
    grants = [e["tenant"] for e in got_ev if e["event"] == "sched.grant"]
    assert len(grants) == sum(len(w) for w in walls.values())
    assert grants[:2] == ["hot", "hot"]  # the high class first
    assert got_ev == want_ev
    assert got == want
    assert got_m == want_m
    assert got_m["dct_tenant_chip_seconds_total"]


def test_preemption_check_matches_reference(tmp_path, monkeypatch):
    """The monitor's starvation check, driven directly: the same running
    set, waiters and clock give the same victim (once per lease) in both
    packages."""
    monkeypatch.setattr(port_loop_mod, "AlwaysOnLoop", _FakeLoop)
    monkeypatch.setattr(ref_loop_mod, "AlwaysOnLoop", _FakeLoop)
    roster = json.dumps([
        {"name": "h", "priority": "high"}, {"name": "n1"},
        {"name": "n2", "weight": 2.0}, {"name": "l1", "priority": "low"},
        {"name": "l2", "priority": "low", "weight": 3.0}])
    out = {}
    for side, pkg, sched_cls, run_cls, obs_cls in (
            ("port", port_sched, SchedulerConfig, RunConfig,
             ObservabilityConfig),
            ("ref", ref_sched, RefSchedConfig, RefRunConfig, RefObsConfig)):
        clock = _Clock()
        cfg = run_cls(
            obs=obs_cls(events_dir=str(tmp_path / side / "ev"),
                        run_id="dct-p"),
            sched=sched_cls(root=str(tmp_path / side / "t"), concurrent=2,
                            preempt_wait_s=2.0))
        kw = {"device": "cpu"} if side == "port" else {}
        sched = pkg.WorkloadScheduler(cfg, tenants=pkg.parse_tenants(roster),
                                      clock=clock, **kw)
        for i, spec in enumerate(sched.tenants):
            sched._runtimes[spec.name] = sched._build_runtime(spec, i)
        rng = np.random.default_rng(5)
        names = list(sched._runtimes)
        trace = []
        for _ in range(60):
            with sched._cond:
                running = set(sched._active)
                if len(running) < 2 and rng.random() < 0.6:
                    idle = [n for n in names if n not in running]
                    n = idle[int(rng.integers(0, len(idle)))]
                    rt = sched._runtimes[n]
                    rt.state, rt.lease_t0, rt.preempt_sent = (
                        "running", clock(), False)
                    sched._active.add(n)
                for n in names:
                    rt = sched._runtimes[n]
                    if n not in sched._active and rng.random() < 0.3:
                        rt.state = "waiting"
                        rt.wait_started = clock() - float(rng.uniform(0, 4))
                victim = sched._preemption_check()
                trace.append((victim.name if victim else None,
                              sched.preempts))
            clock.advance(float(rng.uniform(0.1, 3.0)))
            if victim is not None or (sched._active and rng.random() < 0.3):
                who = victim or sched._runtimes[sorted(sched._active)[0]]
                sched._release(who, {"preempted": victim is not None})
        out[side] = (trace, sched.ledger.report(), [_strip(e) for e in
                     _sched_events(str(tmp_path / side / "ev"),
                                   "sched.preempt", "sched.release")])
    assert out["port"] == out["ref"]
    assert any(v for v, _ in out["port"][0])


# ----------------------------------------------------------------------
# The loop's scheduler hooks.


def _loop_cfg(base, **loop):
    return RunConfig(
        data=DataConfig(processed_dir=os.path.join(base, "p"),
                        raw_csv=os.path.join(base, "raw.csv"),
                        models_dir=os.path.join(base, "m")),
        obs=ObservabilityConfig(events_dir=os.path.join(base, "ev"),
                                heartbeat_dir=os.path.join(base, "hb")),
        loop=LoopConfig(train_mode="inline",
                        packages_dir=os.path.join(base, "pkgs"), **loop))


def test_round_gate_false_stops_loop_cleanly(tmp_path):
    loop = port_loop_mod.AlwaysOnLoop(
        _loop_cfg(str(tmp_path), poll_s=0, eval_poll_s=0), device="cpu",
        round_gate=lambda: False)
    summary = loop.run()
    assert summary["rounds"] == 0 and summary["reason"] == "gate_closed"
    assert summary["error"] is None and summary["preempted_rounds"] == 0


def test_loop_preempt_round_keeps_session_alive(tmp_path, monkeypatch):
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    base = str(tmp_path)
    monkeypatch.setenv("DCT_TRACKING_DIR", os.path.join(base, "mlruns"))
    cfg = _loop_cfg(base, poll_s=0, eval_poll_s=0, epochs_per_round=100,
                    max_rounds=2)
    generate_weather_csv(cfg.data.raw_csv, rows=400, seed=11)
    preprocess_csv_to_parquet(cfg.data.raw_csv, cfg.data.processed_dir)
    records = []
    loop = port_loop_mod.AlwaysOnLoop(cfg, device="cpu",
                                      on_round=records.append)

    def preempt_round_one():
        deadline = time.time() + 120
        while time.time() < deadline and loop._inline_guard is None:
            time.sleep(0.02)
        time.sleep(0.2)  # some epochs run
        loop.preempt_round()

    t = threading.Thread(target=preempt_round_one, daemon=True)
    t.start()
    summary = loop.run()
    t.join(timeout=5)
    assert not t.is_alive()
    # Round 1 revoked, round 2 completed the trajectory to its target.
    assert summary["preempted_rounds"] == 1 and summary["rounds"] == 2
    assert summary["reason"] == "max_rounds" and summary["error"] is None
    assert [r.get("preempted") for r in records] == [True, None]
    # Every record books its completed epochs' seconds, the revoked one's
    # too (they were saved and count toward the trajectory).
    assert records[0]["goodput_s"] > 0 and records[1]["goodput_s"] > 0
    assert len(_events(os.path.join(base, "ev", "events.jsonl"),
                       "preempt.checkpoint_saved")) == 1
    with open(os.path.join(base, "m", "train_state", "p0", "state",
                           "meta.json")) as f:
        assert json.load(f)["epochs_completed"] == 100


def test_fault_spec_requires_supervised_mode(tmp_path):
    cfg = RunConfig(
        obs=ObservabilityConfig(events_dir=str(tmp_path / "ev"),
                                heartbeat_dir=str(tmp_path / "hb")),
        sched=SchedulerConfig(root=str(tmp_path / "tenants")))
    sched = port_sched.WorkloadScheduler(
        cfg, device="cpu",
        tenants=[port_sched.TenantSpec(
            name="chaos", env={"DCT_FAULT_SPEC": "crash@rank0:epoch1"})],
        base_env={"DCT_LOOP_TRAIN_MODE": "inline"})
    with pytest.raises(port_sched.TenantSpecError, match="supervised"):
        sched.start()
    sched.request_stop("test")


def test_ts_dir_raises_naming_item_27(tmp_path, monkeypatch):
    monkeypatch.setenv("DCT_TS_DIR", str(tmp_path / "ts"))
    sched = port_sched.WorkloadScheduler(
        RunConfig(sched=SchedulerConfig(root=str(tmp_path / "t"))),
        device="cpu", tenants=[port_sched.TenantSpec(name="a")])
    with pytest.raises(ValueError, match="item 27"):
        sched.start()


# ----------------------------------------------------------------------
# A real 2-tenant inline session (module-scoped rig).

_BASE_ENV = {
    "DCT_LOOP_TRAIN_MODE": "inline",
    "DCT_LOOP_SOAK_S": "0.05",
    "DCT_LOOP_POLL_S": "0.2",
    "DCT_LOOP_EVAL_POLL_S": "0.2",
}


@pytest.fixture(scope="module")
def session_rig(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("sched_session"))
    raw = os.path.join(base, "raw", "weather.csv")
    generate_weather_csv(raw, rows=400, seed=7)
    saved = os.environ.get("DCT_TRACKING_DIR")
    os.environ["DCT_TRACKING_DIR"] = os.path.join(base, "mlruns")
    cfg = RunConfig(
        obs=ObservabilityConfig(
            events_dir=os.path.join(base, "events"),
            heartbeat_dir=os.path.join(base, "hb"),
            metrics_dir=os.path.join(base, "metrics"),
            metrics_publish_s=0.2),
        sched=SchedulerConfig(root=os.path.join(base, "tenants"),
                              poll_s=0.2))
    tenants = port_sched.parse_tenants(json.dumps([
        {"name": "alpha", "weight": 1.0}, {"name": "beta", "weight": 2.0}]))
    sched = port_sched.WorkloadScheduler(
        cfg, tenants=tenants, device="cpu", base_env={
            **_BASE_ENV, "DCT_RAW_CSV": raw,
            "DCT_LOOP_EPOCHS_PER_ROUND": "2", "DCT_LOOP_MAX_ROUNDS": "1"})
    summary = sched.run()
    yield cfg, sched, summary
    if saved is None:
        os.environ.pop("DCT_TRACKING_DIR", None)
    else:
        os.environ["DCT_TRACKING_DIR"] = saved


def test_session_isolates_tenants(session_rig):
    from dct_tpu_torch.ops.build import BUILD_DIR

    cfg, sched, summary = session_rig
    root = cfg.sched.root
    assert summary["reason"] == "completed"
    for name in ("alpha", "beta"):
        t = summary["tenants"][name]
        assert t["state"] == "stopped" and t["rounds"] == 1
        assert t.get("error") is None and t["promotions"] >= 1
        assert os.path.isdir(os.path.join(root, name, "models"))
        assert os.path.isdir(os.path.join(root, name, "processed"))
        rounds = _tenant_events(root, name, "loop.round")
        assert rounds and rounds[0]["run_id"] == f"{sched.run_id}-{name}"
        assert rounds[0]["goodput_s"] > 0
        fits = _tenant_events(root, name, "fit_start")
        assert [f["run_id"] for f in fits] == [f"{sched.run_id}-{name}"]
        # Its own endpoint, in its own packages dir.
        with open(os.path.join(root, name, "packages",
                               "endpoint_state.json")) as f:
            assert list(json.load(f)) == [name]
    grants = _sched_events(cfg.obs.events_dir, "sched.grant")
    releases = _sched_events(cfg.obs.events_dir, "sched.release")
    assert sorted(g["tenant"] for g in grants) == ["alpha", "beta"]
    assert [r["outcome"] for r in releases] == ["ok", "ok"]
    assert len(_sched_events(cfg.obs.events_dir, "tenant.stop")) == 2
    assert not _sched_events(cfg.obs.events_dir, "tenant.parked")
    start = _sched_events(cfg.obs.events_dir, "sched.start")[0]
    assert start["kernel_build_dir"] == BUILD_DIR
    assert start["device"] == "cpu" and start["shared_cache"] is True


def test_session_ledger_on_aggregated_metrics(session_rig):
    """The per-tenant quota and goodput ledger lands under a ``tenant``
    label on ONE aggregated scrape (the final snapshot included), beside
    the trainers' live per-epoch gauges."""
    cfg, _sched, summary = session_rig
    body, merged = aggregate_text(cfg.obs.metrics_dir, stale_s=0)
    chip = merged.metrics["dct_tenant_chip_seconds_total"]
    assert {dict(k)["tenant"] for k in chip["totals"]} == {"alpha", "beta"}
    for name in ("alpha", "beta"):
        assert chip["totals"][(("tenant", name),)] == pytest.approx(
            summary["tenants"][name]["granted_chip_s"], rel=0.01)
    assert merged.value("dct_tenant_quota_share",
                        {"tenant": "beta"}) == pytest.approx(2 / 3, abs=1e-3)
    assert "dct_tenant_round_wait_seconds_bucket" in body
    assert 'dct_tenant_rounds_total{outcome="ok",tenant="alpha"}' in body
    snaps = [json.load(open(os.path.join(cfg.obs.metrics_dir, n)))
             for n in os.listdir(cfg.obs.metrics_dir)]
    assert [s["final"] for s in snaps if s["proc"].startswith("scheduler")
            ] == [True]


# ----------------------------------------------------------------------
# Starvation preemption of an inline round; a parked tenant.


def _stage_when(path, rows, seed, trigger):
    """Write the staging CSV ``path`` once ``trigger()`` holds (a data
    arrival mid-session)."""
    def run():
        deadline = time.time() + 120
        while time.time() < deadline and not trigger():
            time.sleep(0.02)
        generate_weather_csv(path, rows=rows, seed=seed)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_high_priority_preempts_running_low_round(tmp_path, monkeypatch):
    base = str(tmp_path)
    raw_bulk = os.path.join(base, "raw", "bulk.csv")
    raw_hot = os.path.join(base, "raw", "hot.csv")
    generate_weather_csv(raw_bulk, rows=3000, seed=7)
    monkeypatch.setenv("DCT_TRACKING_DIR", os.path.join(base, "mlruns"))
    cfg = RunConfig(
        obs=ObservabilityConfig(events_dir=os.path.join(base, "events"),
                                heartbeat_dir=os.path.join(base, "hb")),
        sched=SchedulerConfig(root=os.path.join(base, "tenants"),
                              poll_s=0.1, preempt_wait_s=0.5, max_rounds=2,
                              max_wall_s=300.0))
    tenants = port_sched.parse_tenants(json.dumps([
        {"name": "bulk", "priority": "low",
         "env": {"DCT_RAW_CSV": raw_bulk,
                 "DCT_LOOP_EPOCHS_PER_ROUND": "1000"}},
        {"name": "hot", "priority": "high",
         "env": {"DCT_RAW_CSV": raw_hot, "DCT_LOOP_EPOCHS_PER_ROUND": "1"}},
    ]))
    root = cfg.sched.root
    # The high tenant's data arrives once the low tenant's round trains.
    stager = _stage_when(raw_hot, 600, 8, lambda: _tenant_events(
        root, "bulk", "fit_start"))
    sched = port_sched.WorkloadScheduler(cfg, tenants=tenants, device="cpu",
                                         base_env=_BASE_ENV)
    summary = sched.run()
    stager.join(timeout=5)
    preempts = _sched_events(cfg.obs.events_dir, "sched.preempt")
    assert [(p["tenant"], p["waiter"]) for p in preempts] == [("bulk", "hot")]
    assert summary["preempts"] == 1
    bulk_rounds = _tenant_events(root, "bulk", "loop.round")
    assert bulk_rounds and bulk_rounds[0].get("preempted") is True
    assert _tenant_events(root, "bulk", "preempt.checkpoint_saved")
    assert _tenant_events(root, "bulk", "resume_state_saved")
    assert summary["tenants"]["bulk"]["state"] == "stopped"
    assert summary["tenants"]["bulk"]["preempted_rounds"] == 1
    outcomes = [(r["tenant"], r["outcome"]) for r in _sched_events(
        cfg.obs.events_dir, "sched.release")]
    assert outcomes == [("bulk", "preempted"), ("hot", "ok")]


def test_broken_tenant_parks_without_touching_peer(tmp_path, monkeypatch):
    base = str(tmp_path)
    raw_ok = os.path.join(base, "raw", "ok.csv")
    raw_short = os.path.join(base, "raw", "short.csv")
    generate_weather_csv(raw_ok, rows=400, seed=9)
    # Fewer rows than one window: every round of the broken tenant raises.
    generate_weather_csv(raw_short, rows=20, seed=9)
    monkeypatch.setenv("DCT_TRACKING_DIR", os.path.join(base, "mlruns"))
    cfg = RunConfig(
        obs=ObservabilityConfig(events_dir=os.path.join(base, "events"),
                                heartbeat_dir=os.path.join(base, "hb")),
        sched=SchedulerConfig(root=os.path.join(base, "tenants"),
                              poll_s=0.2))
    tenants = port_sched.parse_tenants(json.dumps([
        {"name": "broken", "family": "weather_transformer",
         "env": {"DCT_RAW_CSV": raw_short, "DCT_SEQ_LEN": "64",
                 "DCT_D_MODEL": "16", "DCT_N_HEADS": "2",
                 "DCT_N_LAYERS": "1", "DCT_D_FF": "32"}},
        {"name": "healthy", "env": {"DCT_RAW_CSV": raw_ok}},
    ]))
    sched = port_sched.WorkloadScheduler(cfg, tenants=tenants, device="cpu",
                                         base_env={
        **_BASE_ENV, "DCT_LOOP_EPOCHS_PER_ROUND": "1",
        "DCT_LOOP_MAX_ROUNDS": "2"})
    summary = sched.run()
    assert summary["tenants"]["broken"]["state"] == "parked"
    assert summary["tenants"]["broken"]["parked_reason"] == "train_error"
    parked = _sched_events(cfg.obs.events_dir, "tenant.parked")
    assert [(p["tenant"], p["classification"]) for p in parked] == [
        ("broken", "error")]
    h = summary["tenants"]["healthy"]
    assert h["state"] == "stopped" and h["rounds"] == 2
    assert h.get("error") is None
    assert len(_tenant_events(cfg.sched.root, "healthy", "loop.round")) == 2


# ----------------------------------------------------------------------
# scheduler_job: a supervised revocation, and the exit codes.


def _job_env(base, tenants, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    # One intra-op thread a process: the job and every rank it starts run
    # batch-4 CPU steps, and on a machine whose cores are busy with other
    # tests torch's default (a thread per core) makes each op wait for
    # preempted threads (with six busy processes beside it, the revocation
    # session took 263 s so, and 29 s with one thread).
    env.update(
        OMP_NUM_THREADS="1",
        PYTHONPATH=REPO, DCT_DEVICE="cpu", DCT_TENANTS=json.dumps(tenants),
        DCT_SCHED_ROOT=os.path.join(base, "tenants"),
        DCT_EVENTS_DIR=os.path.join(base, "events"),
        DCT_HEARTBEAT_DIR=os.path.join(base, "hb"),
        DCT_TRACKING_DIR=os.path.join(base, "mlruns"),
        DCT_SCHED_POLL_S="0.1", DCT_LOOP_SOAK_S="0.05",
        DCT_LOOP_POLL_S="0.2", DCT_LOOP_EVAL_POLL_S="0.2", **extra)
    return env


def _run_job(env, base, timeout=240):
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.scheduler_job"],
                       env=env, cwd=base, capture_output=True, text=True,
                       timeout=timeout)
    line = [x for x in r.stdout.splitlines()
            if x.startswith("[scheduler_job] summary ")]
    summary = (json.loads(line[-1][len("[scheduler_job] summary "):])
               if line else None)
    return r, summary


def test_supervised_round_revoked_exits_75_and_resumes(tmp_path):
    """A low tenant's supervised world is revoked by a starved high
    tenant: the ranks are SIGTERMed and exit 75, the supervisor returns
    ``supervise_preempted`` without relaunching, and the next lease
    resumes the trajectory (each epoch trained once). A third tenant's
    nan under the halt policy exits 76 and parks it (job exit 1)."""
    base = str(tmp_path)
    raw_bulk = os.path.join(base, "raw", "bulk.csv")
    raw_hot = os.path.join(base, "raw", "hot.csv")
    generate_weather_csv(raw_bulk, rows=2000, seed=7)
    root = os.path.join(base, "tenants")
    tenants = [
        {"name": "bulk", "priority": "low",
         "env": {"DCT_RAW_CSV": raw_bulk, "DCT_LOOP_EPOCHS_PER_ROUND": "3",
                 "DCT_LOOP_MAX_ROUNDS": "2", "DCT_USE_SCAN": "0",
                 "DCT_FAULT_SPEC": "slow_epoch@rank0:epoch0",
                 "DCT_FAULT_SLEEP_S": "4"}},
        {"name": "hot", "priority": "high",
         "env": {"DCT_RAW_CSV": raw_hot, "DCT_LOOP_EPOCHS_PER_ROUND": "1",
                 "DCT_LOOP_MAX_ROUNDS": "1"}},
        {"name": "sick", "priority": "low",
         "env": {"DCT_RAW_CSV": raw_bulk, "DCT_FAULT_SPEC": "nan:epoch0",
                 "DCT_HALT_ON_NAN": "1", "DCT_LOOP_EPOCHS_PER_ROUND": "1"}},
    ]
    env = _job_env(base, tenants, DCT_SCHED_PREEMPT_WAIT_S="0.5",
                   DCT_LOOP_TRAIN_MODE="supervised",
                   DCT_METRICS_DIR=os.path.join(base, "metrics"),
                   DCT_METRICS_PUBLISH_S="0.2")
    stager = _stage_when(raw_hot, 400, 8, lambda: _tenant_events(
        root, "bulk", "fault.injected"))
    r, summary = _run_job(env, base)
    stager.join(timeout=5)
    assert r.returncode == 1, r.stdout[-3000:] + r.stderr[-3000:]
    preempts = _sched_events(os.path.join(base, "events"), "sched.preempt")
    assert [(p["tenant"], p["waiter"]) for p in preempts] == [("bulk", "hot")]
    bulk = _tenant_events(root, "bulk")
    names = [e["event"] for e in bulk]
    assert names.count("supervise_preempted") == 1
    assert "restart.relaunch" not in names
    assert [e["returncode"] for e in bulk if e["event"] == "rank_exit"] == [
        75, 0]
    assert [e["epoch"] for e in bulk if e["event"] == "epoch_end"] == [
        0, 1, 2]
    rounds = [e for e in bulk if e["event"] == "loop.round"]
    assert [e.get("preempted") for e in rounds] == [True, None]
    assert all(e["goodput_s"] > 0 for e in rounds)
    t = summary["tenants"]
    assert t["bulk"]["state"] == "stopped" and t["bulk"]["rounds"] == 2
    assert t["hot"]["state"] == "stopped" and t["hot"]["rounds"] == 1
    assert t["sick"]["state"] == "parked"
    parked = _sched_events(os.path.join(base, "events"), "tenant.parked")
    assert [(p["tenant"], p["classification"]) for p in parked] == [
        ("sick", "health_halt")]
    assert [e["returncode"] for e in _tenant_events(
        root, "sick", "rank_exit")] == [76]
    # The supervisors' restart accounting and the launchers' progress
    # gauges reached the metrics plane; the scheduler's account too.
    _, merged = aggregate_text(os.path.join(base, "metrics"), stale_s=0)
    assert merged.value("dct_tenant_parked", {"tenant": "sick"}) == 1
    assert merged.value("dct_sched_preempts_total", {"tenant": "bulk"}) == 1
    assert merged.value("dct_tenant_rounds_total",
                        {"tenant": "bulk", "outcome": "preempted"}) == 1


@pytest.mark.parametrize("case", ["clean", "rejected", "inline_fault"])
def test_scheduler_job_exit_codes(case, tmp_path):
    base = str(tmp_path)
    raw = os.path.join(base, "raw", "weather.csv")
    if case == "clean":
        generate_weather_csv(raw, rows=400, seed=3)
        tenants = [{"name": "a"}, {"name": "b", "weight": 2}]
        extra = {"DCT_RAW_CSV": raw, "DCT_LOOP_TRAIN_MODE": "inline",
                 "DCT_LOOP_EPOCHS_PER_ROUND": "1", "DCT_SCHED_MAX_ROUNDS": "3"}
    elif case == "rejected":
        tenants = [{"name": "a", "env": {"DCT_RUN_ID": "x"}}]
        extra = {}
    else:
        tenants = [{"name": "a", "env": {"DCT_FAULT_SPEC": "crash"}}]
        extra = {"DCT_LOOP_TRAIN_MODE": "inline"}
    r, summary = _run_job(_job_env(base, tenants, **extra), base)
    if case == "clean":
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        assert summary["reason"] == "max_rounds"
        assert summary["total_rounds"] == 3
        launches = json.loads([x for x in r.stdout.splitlines() if x.startswith(
            "[scheduler_job] launches ")][-1].split(" ", 2)[2])
        assert launches == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                            "flash_bwd_dq": 0}  # the plain path on the CPU
    else:
        assert r.returncode == 2 and summary is None
        assert ("reserved" if case == "rejected" else "supervised") in r.stderr
