"""The port's resilience plane against the JAX package's on the same inputs
(CPU): the settings, the fault-spec grammar and its firing semantics, the
failure classifier, the restart policy's delays, the preemption guard, and
the checkpoint tiers' save-fault points (a torn save leaves only ``*.tmp``
debris and is skipped on restore)."""

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from dct_tpu import config as ref_config
from dct_tpu.resilience import faults as ref_faults
from dct_tpu.resilience import supervisor as ref_supervisor
from dct_tpu_torch import config
from dct_tpu_torch.resilience import faults, supervisor
from dct_tpu_torch.resilience.preempt import PreemptedError, PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- settings -------------------------------------------------------------

ENV_OF = {
    "ObservabilityConfig": {
        "enabled": ("DCT_OBSERVABILITY", "0"),
        "events_dir": ("DCT_EVENTS_DIR", "/tmp/ev"),
        "run_id": ("DCT_RUN_ID", "dct-abc"),
        "heartbeat_dir": ("DCT_HEARTBEAT_DIR", "/tmp/hb"),
        "heartbeat_interval": ("DCT_HEARTBEAT_INTERVAL", "0.5"),
        "heartbeat_stall_seconds": ("DCT_HEARTBEAT_STALL_SECONDS", "9"),
        "spans_dir": ("DCT_SPANS_DIR", "/tmp/sp"),
        "halt_on_nan": ("DCT_HALT_ON_NAN", "1"),
        "halt_on_spike": ("DCT_HALT_ON_SPIKE", "yes"),
        "spike_zscore": ("DCT_SPIKE_ZSCORE", "3.5"),
        "spike_window": ("DCT_SPIKE_WINDOW", "7"),
        "metrics_dir": ("DCT_METRICS_DIR", "/tmp/metrics"),
        "metrics_publish_s": ("DCT_METRICS_PUBLISH_S", "0.25"),
        "metrics_stale_s": ("DCT_METRICS_STALE_S", "12"),
    },
    "SchedulerConfig": {
        "spec": ("DCT_TENANTS", '[{"name":"a"}]'),
        "root": ("DCT_SCHED_ROOT", "/tmp/tenants"),
        "concurrent": ("DCT_SCHED_CONCURRENT", "2"),
        "poll_s": ("DCT_SCHED_POLL_S", "0.1"),
        "preempt_wait_s": ("DCT_SCHED_PREEMPT_WAIT_S", "1.5"),
        "shared_cache": ("DCT_SCHED_SHARED_CACHE", "0"),
        "max_wall_s": ("DCT_SCHED_MAX_WALL_S", "30"),
        "max_rounds": ("DCT_SCHED_MAX_ROUNDS", "7"),
    },
    "ResilienceConfig": {
        "max_restarts": ("DCT_MAX_RESTARTS", "5"),
        "restart_backoff_s": ("DCT_RESTART_BACKOFF_S", "0.25"),
        "restart_backoff_factor": ("DCT_RESTART_BACKOFF_FACTOR", "3"),
        "restart_jitter": ("DCT_RESTART_JITTER", "0"),
        "preempt_grace_s": ("DCT_PREEMPT_GRACE_S", "4"),
        "graceful_preemption": ("DCT_GRACEFUL_PREEMPTION", "off"),
        "fault_spec": ("DCT_FAULT_SPEC", "crash@rank0:epoch1"),
        "fault_sleep_s": ("DCT_FAULT_SLEEP_S", "0.1"),
    },
}


@pytest.mark.parametrize("name", sorted(ENV_OF))
def test_config_fields_defaults_and_env_names_match_reference(
        name, monkeypatch):
    port_cls, ref_cls = getattr(config, name), getattr(ref_config, name)
    fields = [f.name for f in dataclasses.fields(port_cls)]
    assert sorted(fields) == sorted(ENV_OF[name])
    for f in fields:
        assert getattr(port_cls(), f) == getattr(ref_cls(), f), f
    for var, _ in ENV_OF[name].values():
        monkeypatch.delenv(var, raising=False)
    for f in fields:
        assert getattr(port_cls.from_env(), f) == getattr(
            ref_cls.from_env(), f), f
    for var, value in ENV_OF[name].values():
        monkeypatch.setenv(var, value)
    port, ref = port_cls.from_env(), ref_cls.from_env()
    for f in fields:
        assert getattr(port, f) == getattr(ref, f), f
        assert getattr(port, f) != getattr(port_cls(), f), f  # var is read


def test_run_config_carries_obs_and_resilience(monkeypatch):
    monkeypatch.setenv("DCT_FAULT_SPEC", "hang@rank0:step3")
    monkeypatch.setenv("DCT_HALT_ON_NAN", "1")
    cfg = config.RunConfig.from_env()
    assert cfg.resilience.fault_spec == "hang@rank0:step3"
    assert cfg.obs.halt_on_nan is True
    assert "obs" in cfg.to_dict() and "resilience" in cfg.to_dict()


# -- fault-spec grammar -----------------------------------------------------

SPECS = [
    "crash@rank1:epoch2,hang@rank0:step10,nan@rank1:epoch1,slow_save",
    "crash_save:save2",
    "slow_epoch@rank0:epoch1",
    "slow_score:ms25,crash_worker@proc1:req50",
    " crash , nan:epoch0 ,",
    "",
]


def _clauses(plan):
    return [(c.action, c.rank, c.trigger, c.at, c.raw) for c in plan.clauses]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_like_reference(spec):
    got = faults.FaultPlan.parse(spec, rank=1, sleep_s=0.5)
    want = ref_faults.FaultPlan.parse(spec, rank=1, sleep_s=0.5)
    assert _clauses(got) == _clauses(want)
    assert got.enabled == want.enabled and got.sleep_s == want.sleep_s


@pytest.mark.parametrize("spec", [
    "explode@rank0:epoch1", "crash@rank0:minute5", "crash:ms5",
    "nan:req3", "crash@node1", "CRASH",
])
def test_fault_spec_rejects_like_reference(spec):
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as want:
        ref_faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_fault_checks_fire_like_reference(tmp_path, monkeypatch):
    """The same hook calls on both plans give the same clauses, fired
    flags and save ordinals."""
    from dct_tpu.observability import events as ref_events
    from dct_tpu_torch.observability import events

    monkeypatch.setattr(events, "_explicit", None)
    monkeypatch.setattr(ref_events, "_explicit", None)
    monkeypatch.setenv("DCT_EVENTS_DIR", str(tmp_path / "ev"))
    monkeypatch.setenv("DCT_RUN_ID", "dct-faulttest")
    spec = ("nan@rank1:epoch1,hang:step10,crash_save:save3,"
            "slow_score:ms5,crash_worker:req4")
    calls = [("data", {"epoch": 1}), ("data", {"epoch": 1}),
             ("step", {"step": 9}), ("step", {"step": 12}),
             ("save", {}), ("save", {}), ("save", {}), ("save", {}),
             ("score", {"req": 2}), ("score", {"req": 5}),
             ("score", {"req": 6}), ("epoch", {"epoch": 0})]
    for rank in (0, 1):
        got = faults.FaultPlan.parse(spec, rank=rank)
        want = ref_faults.FaultPlan.parse(spec, rank=rank)
        seq = []
        for point, coords in calls:
            a, b = got.check(point, **coords), want.check(point, **coords)
            seq.append((a and a.raw, b and b.raw))
        assert [a for a, _ in seq] == [b for _, b in seq]
        assert got.fired_count == want.fired_count
    # The port's records (written before emit returns; the reference's
    # may still sit in its buffer): one crash_save per rank, at save 3.
    recs = [json.loads(x) for x in open(tmp_path / "ev" / "events.jsonl")]
    assert {r["event"] for r in recs} == {"fault.injected"}
    save = [r for r in recs if r["action"] == "crash_save"]
    assert len(save) >= 2 and {r["save"] for r in save} == {3}


def test_maybe_fire_sleeps_and_leaves_the_rest_to_the_caller():
    plan = faults.FaultPlan.parse("slow_epoch:epoch2,nan:epoch0",
                                  sleep_s=0.25)
    sleeps = []
    plan._sleep = sleeps.append
    assert plan.maybe_fire("epoch", epoch=1) is None
    assert plan.maybe_fire("epoch", epoch=2) is None and sleeps == [0.25]
    assert plan.maybe_fire("data", epoch=0).action == "nan"
    assert faults.FAULT_CRASH_EXIT == ref_faults.FAULT_CRASH_EXIT == 117


def test_default_plan_follows_env_and_tolerates_a_bad_spec(monkeypatch):
    monkeypatch.setattr(faults, "_explicit", None)
    monkeypatch.setenv("DCT_FAULT_SPEC", "crash@rank0:epoch3")
    assert _clauses(faults.get_default())[0][:4] == ("crash", 0, "epoch", 3)
    monkeypatch.setenv("DCT_FAULT_SPEC", "explode")
    assert not faults.get_default().enabled
    plan = faults.FaultPlan.parse("nan")
    faults.set_default(plan)
    try:
        assert faults.get_default() is plan
    finally:
        faults.set_default(None)


# -- failure classification + restart policy ---------------------------------

P, H = ref_supervisor.EXIT_PREEMPTED, ref_supervisor.EXIT_HEALTH_HALT
I1, I2 = ref_supervisor.EXIT_INFRA_HEALTHCHECK, ref_supervisor.EXIT_INFRA_CLEANUP


@pytest.mark.parametrize("codes,kw,expect", [
    ([0, 0], {}, "success"),
    ([0, 7], {}, "crash"),
    ([0, 117], {}, "crash"),
    ([-9, 1], {}, "crash"),
    ([P, P], {}, "preempted"),
    ([P, -9], {}, "preempted"),
    ([P, 7], {}, "crash"),
    ([0, H], {}, "health_halt"),
    ([I1], {}, "infra"),
    ([I2], {}, "infra"),
    ([-9, -9], {}, "crash"),
    ([-9, 0], {"stall_killed": True}, "hang"),
    ([-9, 0], {"timed_out": True}, "hang"),
    ([H, I1], {}, "infra"),
    ([P, H], {"stall_killed": True}, "health_halt"),
])
def test_classify_failure_matches_reference(codes, kw, expect):
    assert supervisor.classify_failure(codes, **kw) == expect
    assert ref_supervisor.classify_failure(codes, **kw) == expect


def test_exit_codes_and_restart_classes_match_reference():
    for name in ("EXIT_PREEMPTED", "EXIT_HEALTH_HALT",
                 "EXIT_INFRA_HEALTHCHECK", "EXIT_INFRA_CLEANUP",
                 "RESUMABLE", "FREE_RESTARTS"):
        assert getattr(supervisor, name) == getattr(ref_supervisor, name)


@pytest.mark.parametrize("kw", [
    {}, {"max_restarts": 3, "backoff_s": 0.5, "backoff_factor": 3.0,
         "jitter": 0.25},
])
def test_restart_policy_delays_match_reference_under_one_seed(kw):
    got = supervisor.RestartPolicy(**kw, rng=random.Random(7).random)
    want = ref_supervisor.RestartPolicy(**kw, rng=random.Random(7).random)
    assert [got.delay(n) for n in range(6)] == [
        want.delay(n) for n in range(6)]
    for used in range(5):
        for cls in ("crash", "hang", "infra", "preempted", "health_halt",
                    "success"):
            assert got.allows(used, cls) == want.allows(used, cls)


# -- preemption guard ----------------------------------------------------------


def test_preemption_guard_flags_sigterm_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(clock=lambda: 123.0).install()
    try:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and guard.signal_time == 123.0
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev
    guard.uninstall()  # idempotent
    assert issubclass(PreemptedError, RuntimeError)


def test_preemption_guard_is_a_no_op_off_the_main_thread():
    prev = signal.getsignal(signal.SIGTERM)
    out = {}

    def work():
        g = PreemptionGuard().install()
        out["installed"] = g._installed
        g.uninstall()

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert out == {"installed": False}
    assert signal.getsignal(signal.SIGTERM) == prev


# -- the checkpoint tiers' save-fault points -----------------------------------


def _run_py(code: str, env: dict) -> subprocess.CompletedProcess:
    full = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    full.update(env)
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], env=full,
                          capture_output=True, text=True, timeout=120)


def test_deploy_tier_crash_mid_write_never_publishes_torn_file(tmp_path):
    target = tmp_path / "models" / "last.ckpt"
    code = ("import numpy as np\n"
            "from dct_tpu_torch.checkpoint.manager import save_checkpoint\n"
            f"save_checkpoint({str(target)!r}, "
            "{{'params': {{'w': np.full(3, {v}, np.float32)}}}}, "
            "{{'epoch': {v}}})\n")
    assert _run_py(code.format(v=0), {}).returncode == 0
    first = target.read_bytes()
    proc = _run_py(code.format(v=1), {
        "DCT_FAULT_SPEC": "crash_save",
        "DCT_EVENTS_DIR": str(tmp_path / "ev")})
    assert proc.returncode == faults.FAULT_CRASH_EXIT, proc.stderr
    assert target.read_bytes() == first
    assert [p.name for p in target.parent.iterdir() if ".tmp" in p.name]
    from dct_tpu_torch.checkpoint.manager import load_checkpoint

    assert load_checkpoint(str(target))[1]["epoch"] == 0
    rec = json.loads(open(tmp_path / "ev" / "events.jsonl").readline())
    assert (rec["event"], rec["save_kind"], rec["save"]) == (
        "fault.injected", "deploy", 1)


_STATE_CODE = """
import sys
import numpy as np, torch
from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer
from dct_tpu_torch.models.mlp import WeatherMLP
from dct_tpu_torch.train.state import create_train_state
state = create_train_state(WeatherMLP(input_dim=5), input_dim=5, lr=0.01,
                           seed=0)
c = TrainStateCheckpointer(sys.argv[1])
for e in (1, 2):
    with torch.no_grad():
        for p in state.params:
            p.fill_(float(e))
    state.step = e
    c.save(state, meta={"epochs_completed": e})
"""


@pytest.mark.parametrize("spec,torn", [("crash_save:save2", True),
                                       ("slow_save:save2", False)])
def test_resume_tier_save_fault_ordinals_and_torn_restore(tmp_path, spec,
                                                          torn):
    from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer
    from dct_tpu_torch.models.mlp import WeatherMLP
    from dct_tpu_torch.train.state import create_train_state

    state_dir = tmp_path / "train_state" / "p0"
    proc = subprocess.run(
        [sys.executable, "-c", _STATE_CODE, str(state_dir)],
        env={**{k: v for k, v in os.environ.items()
                if not k.startswith("DCT_")},
             "PYTHONPATH": REPO, "DCT_FAULT_SPEC": spec,
             "DCT_FAULT_SLEEP_S": "0.05",
             "DCT_EVENTS_DIR": str(tmp_path / "ev")},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == (faults.FAULT_CRASH_EXIT if torn else 0), (
        proc.stderr)
    recs = [json.loads(x) for x in open(tmp_path / "ev" / "events.jsonl")]
    fired = [r for r in recs if r["event"] == "fault.injected"]
    assert [(r["save"], r["save_kind"]) for r in fired] == [
        (2, "resume_state")]
    saved = [r["epochs_completed"] for r in recs
             if r["event"] == "resume_state_saved"]
    assert saved == ([1] if torn else [1, 2])
    next_dir = state_dir / "state.next"
    if torn:
        assert sorted(os.listdir(next_dir)) == ["state.npz.tmp"]
    ckptr = TrainStateCheckpointer(str(state_dir))
    assert str(next_dir) not in ckptr._restore_candidates()
    assert ckptr.load_meta()["epochs_completed"] == (1 if torn else 2)
    fresh = create_train_state(WeatherMLP(input_dim=5), input_dim=5,
                               lr=0.01, seed=0)
    restored = ckptr.restore(fresh)
    want = 1.0 if torn else 2.0
    assert restored.step == int(want)
    assert all(np.all(p.detach().numpy() == want) for p in restored.params)
