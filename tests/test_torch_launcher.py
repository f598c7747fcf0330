"""The port's launcher (CPU): the four script builders give the reference's
strings byte for byte; the generated scripts run locally, fail fast and
propagate a preemption as 75; ``LocalProcessLauncher`` launches, fails
fast, stall-kills a wedged rank, and supervises fake ranks through crash,
preemption, health halt and its own termination, as the reference's
tests of ``dct_tpu/launch/launcher.py`` do."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from dct_tpu.launch import launcher as ref_launcher
from dct_tpu_torch.launch import launcher
from dct_tpu_torch.launch.launcher import LocalProcessLauncher
from dct_tpu_torch.resilience.supervisor import (
    EXIT_HEALTH_HALT,
    EXIT_INFRA_CLEANUP,
    EXIT_INFRA_HEALTHCHECK,
    EXIT_PREEMPTED,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = ["h0", "h1", "h2"]


@pytest.mark.parametrize("kw", [
    dict(hosts=HOSTS, pattern="train_tpu.py"),
    dict(hosts=["a"], exec_template="docker exec {host} bash -c {cmd}",
         pattern="dct_tpu_torch.train_job", settle_seconds=0),
])
def test_cleanup_script_equals_reference(kw):
    assert launcher.build_zombie_cleanup_script(**kw) == (
        ref_launcher.build_zombie_cleanup_script(**kw))


@pytest.mark.parametrize("kw", [
    dict(hosts=HOSTS, check_command="python3 -c 'import sys'"),
    dict(hosts=["a"], exec_template="bash -c {cmd}", check_command="false"),
])
def test_healthcheck_script_equals_reference(kw):
    assert launcher.build_healthcheck_script(**kw) == (
        ref_launcher.build_healthcheck_script(**kw))


def test_builder_defaults_name_the_port():
    ref = ref_launcher.build_healthcheck_script(HOSTS)
    got = launcher.build_healthcheck_script(HOSTS)
    q = launcher.shlex.quote
    assert got == ref.replace(
        q("python3 -c 'import jax; print(jax.devices())'"),
        q("python3 -c 'import torch; assert torch.cuda.is_available(); "
          "print(torch.cuda.device_count())'"))
    assert launcher.build_zombie_cleanup_script(HOSTS) == (
        ref_launcher.build_zombie_cleanup_script(
            HOSTS, pattern="dct_tpu_torch.train_job"))


@pytest.mark.parametrize("kw", [
    dict(hosts=HOSTS, command="python3 -m dct_tpu_torch.train_job"),
    dict(hosts=["only"], command="python3 t.py", run_id="dct-pinned"),
    dict(hosts=["h0", "h1"], command="sh -c 'exit 0'",
         exec_template="bash -c {cmd}", coordinator_port=29999,
         stagger_seconds=0, fail_fast_poll_seconds=1,
         extra_env={"DCT_EPOCHS": "2", "X": "a b"}),
])
def test_spmd_launch_script_equals_reference(kw):
    assert launcher.build_spmd_launch_script(**kw) == (
        ref_launcher.build_spmd_launch_script(**kw))
    assert launcher.remote_command("ssh {host} {cmd}", "h", "a 'b' $c") == (
        ref_launcher.remote_command("ssh {host} {cmd}", "h", "a 'b' $c"))


def _bash(script):
    return subprocess.run(["bash", "-c", script], capture_output=True,
                          text=True, timeout=120)


def test_launch_script_executes_locally(tmp_path):
    marker = tmp_path / "ranks"
    proc = _bash(launcher.build_spmd_launch_script(
        ["h0", "h1"], f"sh -c 'echo rank=$NODE_RANK world=$WORLD_SIZE "
        f"run=$DCT_RUN_ID >> {marker}'", exec_template="bash -c {cmd}",
        stagger_seconds=0, run_id="dct-script"))
    assert proc.returncode == 0, proc.stderr
    content = marker.read_text()
    assert "rank=0 world=2 run=dct-script" in content
    assert "rank=1 world=2 run=dct-script" in content
    assert "All 2 ranks finished successfully" in proc.stdout


def test_launch_script_fail_fast_kills_survivors():
    t0 = time.monotonic()
    proc = _bash(launcher.build_spmd_launch_script(
        ["h0", "h1"],
        "sh -c 'if [ $NODE_RANK -eq 1 ]; then exit 3; else sleep 100; fi'",
        exec_template="bash -c {cmd}", stagger_seconds=0,
        fail_fast_poll_seconds=1))
    assert proc.returncode == 1 and "fail-fast" in proc.stdout
    assert time.monotonic() - t0 < 30


def test_launch_script_propagates_preemption_as_75():
    proc = _bash(launcher.build_spmd_launch_script(
        ["h0", "h1"], f"sh -c 'exit {EXIT_PREEMPTED}'",
        exec_template="bash -c {cmd}", stagger_seconds=0,
        fail_fast_poll_seconds=1))
    assert proc.returncode == EXIT_PREEMPTED and "resumable" in proc.stdout
    # ...but a hard failure dominates a graceful peer.
    proc = _bash(launcher.build_spmd_launch_script(
        ["h0", "h1"],
        f"sh -c 'if [ $NODE_RANK -eq 1 ]; then exit 7; "
        f"else sleep 10; exit {EXIT_PREEMPTED}; fi'",
        exec_template="bash -c {cmd}", stagger_seconds=0,
        fail_fast_poll_seconds=1))
    assert proc.returncode == 1


def test_infra_exit_codes():
    proc = _bash(launcher.build_healthcheck_script(
        ["h0", "h1"], exec_template="bash -c {cmd}", check_command="false"))
    assert proc.returncode == EXIT_INFRA_HEALTHCHECK
    assert "Healthcheck failed on h0" in proc.stdout
    proc = _bash(launcher.build_zombie_cleanup_script(
        ["h0"], exec_template="false {host} {cmd}", pattern="x"))
    assert proc.returncode == EXIT_INFRA_CLEANUP
    proc = _bash(launcher.build_zombie_cleanup_script(
        ["h0"], exec_template="bash -c {cmd}",
        pattern="no_such_process_pattern_xyz", settle_seconds=0))
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- LocalProcessLauncher ---------------------------------------------------


def _events(tmp_path):
    path = tmp_path / "events" / "events.jsonl"
    return [json.loads(x) for x in open(path)] if path.exists() else []


def _env(tmp_path, **extra):
    return {"DCT_EVENTS_DIR": str(tmp_path / "events"),
            "DCT_HEARTBEAT_DIR": str(tmp_path / "hb"), "DCT_RUN_ID": "",
            **extra}


def test_launch_gives_each_rank_the_rendezvous_and_one_run_id(tmp_path):
    out = tmp_path / "env"
    code = ("import json, os\n"
            f"open({str(out)!r} + os.environ['NODE_RANK'], 'w').write("
            "json.dumps({k: os.environ.get(k) for k in ('MASTER_ADDR', "
            "'MASTER_PORT', 'NODE_RANK', 'WORLD_SIZE', 'DCT_RUN_ID', "
            "'DCT_SPAN_ID', 'DCT_HEARTBEAT_DIR')}))\n")
    res = LocalProcessLauncher(stagger_seconds=0.0, coordinator_port=29877,
                               poll_seconds=0.05).launch(
        [sys.executable, "-c", code], world_size=2, env=_env(tmp_path))
    assert LocalProcessLauncher.all_succeeded(res)
    envs = [json.loads((tmp_path / f"env{r}").read_text()) for r in (0, 1)]
    assert [e["NODE_RANK"] for e in envs] == ["0", "1"]
    assert {e["MASTER_PORT"] for e in envs} == {"29877"}
    assert {e["WORLD_SIZE"] for e in envs} == {"2"}
    assert len({e["DCT_RUN_ID"] for e in envs}) == 1
    assert envs[0]["DCT_RUN_ID"].startswith("dct-")
    assert envs[0]["DCT_SPAN_ID"] == envs[1]["DCT_SPAN_ID"]
    names = [e["event"] for e in _events(tmp_path)]
    assert names[0] == "launch_start" and names[-1] == "launch_end"
    assert names.count("rank_exit") == 2


def test_local_launcher_fail_fast(tmp_path):
    t0 = time.monotonic()
    res = LocalProcessLauncher(stagger_seconds=0.0, timeout=60.0,
                               poll_seconds=0.1).launch(
        [sys.executable, "-c",
         "import os, sys, time\n"
         "sys.exit(5) if os.environ['NODE_RANK'] == '1' else "
         "time.sleep(60)\n"], world_size=2, env=_env(tmp_path))
    assert time.monotonic() - t0 < 30
    assert res[1].returncode == 5 and res[0].returncode != 0


def test_stall_kill_tears_down_a_wedged_rank(tmp_path):
    """A rank that beats once and then stops (PID alive) is flagged
    stalled and killed through SIGTERM -> SIGKILL escalation."""
    code = ("import os, time\n"
            "from dct_tpu_torch.observability.heartbeat import "
            "HeartbeatWriter\n"
            "HeartbeatWriter(os.environ['DCT_HEARTBEAT_DIR'], 0, "
            "run_id=os.environ['DCT_RUN_ID']).beat(step=1, epoch=0)\n"
            "import signal; signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
            "time.sleep(120)\n")
    lch = LocalProcessLauncher(
        stagger_seconds=0.0, timeout=60.0, poll_seconds=0.05,
        heartbeat_stall_seconds=1.5, heartbeat_scan_seconds=0.2,
        preempt_grace_s=0.5, stall_kill=True)
    t0 = time.monotonic()
    res = lch.launch([sys.executable, "-c", code], world_size=1,
                     env=_env(tmp_path, PYTHONPATH=REPO))
    assert time.monotonic() - t0 < 30
    assert res[0].returncode == -signal.SIGKILL and lch._stall_killed
    names = [e["event"] for e in _events(tmp_path)]
    assert "rank_stalled" in names and "restart.stall_kill" in names


def test_unported_planes_raise_naming_item_27(tmp_path):
    # The metrics plane (DCT_METRICS_DIR) is ported: test_torch_metrics_plane
    # drives the launcher and the supervisor with it set.
    lch = LocalProcessLauncher()
    for var in ("DCT_TS_DIR",):
        with pytest.raises(ValueError, match="item 27"):
            lch.launch([sys.executable, "-c", "pass"], world_size=1,
                       env=_env(tmp_path, **{var: str(tmp_path / "m")}))
        with pytest.raises(ValueError, match="item 27"):
            lch.supervise([sys.executable, "-c", "pass"], world_size=1,
                          env=_env(tmp_path, **{var: str(tmp_path / "m")}))


# -- supervise with fake ranks ----------------------------------------------


def _supervise(tmp_path, rank_code, **kw):
    lch = LocalProcessLauncher(stagger_seconds=0.0, timeout=60.0,
                               poll_seconds=0.05, preempt_grace_s=2.0)
    kw.setdefault("max_restarts", 2)
    kw.setdefault("backoff_s", 0.05)
    kw.setdefault("jitter", 0.0)
    res = lch.supervise([sys.executable, "-c", rank_code], world_size=1,
                        env=_env(tmp_path, DCT_FAULT_SPEC="crash"), **kw)
    return res, _events(tmp_path)


def test_supervise_relaunches_a_crash_with_resume(tmp_path):
    marker = tmp_path / "marker"
    code = ("import os, sys\n"
            f"m = {str(marker)!r}\n"
            "if not os.path.exists(m):\n"
            "    open(m, 'w').write('first')\n"
            "    sys.exit(7)\n"
            "open(m + '.relaunch', 'w').write(os.environ.get('DCT_RESUME', "
            "'') + ';' + os.environ.get('DCT_FAULT_SPEC', 'unset'))\n")
    res, events = _supervise(tmp_path, code)
    assert res.success and res.restarts == 1
    assert [a.classification for a in res.attempts] == ["crash", "success"]
    assert (tmp_path / "marker.relaunch").read_text() == "1;"
    relaunch = next(e for e in events if e["event"] == "restart.relaunch")
    assert relaunch["classification"] == "crash"
    assert relaunch["lost_wall_s"] > 0 and relaunch["backoff_s"] == 0.05
    assert events[-1]["event"] == "restart.recovered"
    assert len({e["run_id"] for e in events}) == 1


def test_supervise_gives_up_after_budget(tmp_path):
    res, events = _supervise(tmp_path, "import sys; sys.exit(7)",
                             max_restarts=1)
    assert not res.success and res.restarts == 1 and len(res.attempts) == 2
    assert res.classification == "crash"
    assert events[-1]["event"] == "restart.gave_up"


def test_supervise_never_retries_health_halt(tmp_path):
    res, events = _supervise(tmp_path,
                             f"import sys; sys.exit({EXIT_HEALTH_HALT})")
    assert not res.success and len(res.attempts) == 1
    assert res.classification == "health_halt"
    assert events[-1]["event"] == "restart.gave_up"


def test_supervise_preemption_is_a_free_restart(tmp_path):
    marker = tmp_path / "marker"
    code = ("import os, sys\n"
            f"m = {str(marker)!r}\n"
            "if not os.path.exists(m):\n"
            "    open(m, 'w').write('x')\n"
            f"    sys.exit({EXIT_PREEMPTED})\n")
    res, events = _supervise(tmp_path, code, max_restarts=0)
    assert res.success and res.restarts == 0 and len(res.attempts) == 2
    relaunch = next(e for e in events if e["event"] == "restart.relaunch")
    assert relaunch["classification"] == "preempted"
    assert relaunch["backoff_s"] == 0 and relaunch["lost_wall_s"] == 0


def test_supervisor_termination_tears_down_ranks(tmp_path):
    pidfile = tmp_path / "rank_pid"
    code = ("import os, time\n"
            f"open({str(pidfile)!r}, 'w').write(str(os.getpid()))\n"
            "time.sleep(120)\n")
    lch = LocalProcessLauncher(stagger_seconds=0.0, timeout=120.0,
                               poll_seconds=0.05, preempt_grace_s=1.0)
    prev = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(1.5, lambda: os.kill(os.getpid(),
                                                 signal.SIGTERM))
    timer.start()
    try:
        res = lch.supervise([sys.executable, "-c", code], world_size=1,
                            env=_env(tmp_path), max_restarts=1,
                            backoff_s=0.05, jitter=0.0)
    finally:
        timer.cancel()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert not res.success and res.classification == "preempted"
    pid = int(pidfile.read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)  # reaped before supervise returned
    assert "supervise_terminated" in [e["event"] for e in _events(tmp_path)]


# -- lease revocation (the scheduler's preempt_event) ---------------------


@pytest.mark.parametrize("guarded", [True, False])
def test_supervise_returns_a_revoked_world_without_relaunch(tmp_path,
                                                            guarded):
    """A set preempt_event SIGTERMs the world; a rank with its guard up
    saves and exits 75, a rank still starting dies of the SIGTERM. Either
    way the attempt returns ``supervise_preempted``: no relaunch, no
    restart budget spent."""
    code = ("import signal, sys, time\n"
            + ("signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))\n"
               if guarded else "")
            + "time.sleep(60)\n")
    event = threading.Event()
    timer = threading.Timer(1.0, event.set)
    timer.start()
    lch = LocalProcessLauncher(stagger_seconds=0.0, timeout=60.0,
                               poll_seconds=0.05, preempt_grace_s=5.0)
    t0 = time.monotonic()
    res = lch.supervise([sys.executable, "-c", code], world_size=1,
                        env=_env(tmp_path), backoff_s=0.05, jitter=0.0,
                        preempt_event=event)
    timer.join()
    assert time.monotonic() - t0 < 30
    assert not res.success and res.classification == "preempted"
    assert len(res.attempts) == 1 and res.restarts == 0
    assert [r.returncode for r in res.results] == [
        75 if guarded else -signal.SIGTERM]
    names = [e["event"] for e in _events(tmp_path)]
    assert names.count("supervise_preempted") == 1
    assert "restart.relaunch" not in names


def test_supervise_without_revocation_relaunches_a_sigterm_death(tmp_path):
    """Without a revocation a rank's signal death is a crash, relaunched
    as before."""
    marker = tmp_path / "m"
    code = ("import os, signal\n"
            f"m = {str(marker)!r}\n"
            "if not os.path.exists(m):\n"
            "    open(m, 'w').close(); os.kill(os.getpid(), signal.SIGTERM)\n")
    res, _ = _supervise(tmp_path, code)
    assert res.success and [a.classification for a in res.attempts] == [
        "crash", "success"]
