"""Launch and supervision of a training world (counterpart of
``dct_tpu/launch/launcher.py``).

The script builders generate the shell launch block for any host-access
mechanism (``ssh``, ``docker exec``, ``bash -c``): a zombie purge, a
healthcheck, and the SPMD launch with coordinator env, a staggered start,
a fail-fast join and the exit-code conjunction. They produce the
reference's scripts byte for byte for the same arguments; only the
defaults name the port (the purge pattern is ``dct_tpu_torch.train_job``,
the healthcheck asks torch for CUDA).

:class:`LocalProcessLauncher` applies the same semantics to local
processes, one per rank:

- ``launch``: mints ``DCT_RUN_ID`` (the launcher is the minter of record),
  starts each rank in its own process group with ``MASTER_ADDR``,
  ``MASTER_PORT``, ``NODE_RANK``, ``WORLD_SIZE`` and ``DCT_SPAN_ID`` (the
  launch span, which parents every rank's ``trainer.fit``), staggered
  after rank 0; reaps ranks as they exit and, fail-fast, tears the world
  down on the first nonzero exit (SIGTERM to every group, SIGKILL after
  ``preempt_grace_s``); scans the ranks' heartbeats and, with
  ``stall_kill``, tears the world down when a rank stalls. Events:
  ``launch_start``, ``rank_exit``, ``rank_stalled`` / ``rank_missing``,
  ``restart.stall_kill``, ``launch_end``; spans ``launcher.launch`` and
  one ``launcher.rank`` per rank.
- ``supervise``: runs ``launch`` until the world succeeds, classifying
  each failure (:func:`~dct_tpu_torch.resilience.supervisor.
  classify_failure`) and relaunching resumable ones with ``DCT_RESUME=1``
  and exponential backoff; ``preempted`` is a free restart,
  ``health_halt`` gives up at once. Events: ``supervise_start``,
  ``restart.relaunch``, ``restart.recovered`` / ``supervise_end``,
  ``restart.gave_up``, ``supervise_terminated``. A caller's
  ``preempt_event`` (the multi-tenant scheduler's lease revocation) tears
  the world down gracefully once set: the ranks save and exit 75, and the
  ``preempted`` attempt returns (``supervise_preempted``) instead of
  relaunching, handing the card back.

With ``DCT_METRICS_DIR`` set, both publish on the metrics plane: the
launcher the per-rank progress-age gauge (``dct_rank_progress_age_seconds``,
a live snapshot retired at the launch's end), the supervisor the restart
counters by classification and the lost-wall gauge (a final snapshot). The
anomaly plane over the telemetry history (``DCT_TS_DIR``) is ROADMAP
Queue A item 27; setting it raises ``ValueError`` rather than running
without it. The reference also pins one compile-cache dir into every
attempt; here there is nothing to pin: a relaunched rank loads the kernel
libraries that ``ops/build.py`` left on disk. The goodput ledger that
would book the lost wall clock (``DCT_STARTUP_RECOVERY_DEBT_S``) is item
27 too; the supervisor reports ``lost_wall_s`` on its ``restart.*``
events.

Exec-template quoting contract: ``{cmd}`` is substituted with ONE
shlex-quoted token holding the full shell command, so the template must
hand it to something that parses a shell command string:

- ``ssh {host} {cmd}``                 -- sshd's remote shell re-parses the
  joined argv, recovering the original command;
- ``docker exec {host} bash -c {cmd}`` -- docker passes argv through
  verbatim, so an explicit ``bash -c`` consumes the token;
- ``bash -c {cmd}``                    -- in-place execution (tests).
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

from dct_tpu_torch.observability.aggregate import SnapshotPublisher
from dct_tpu_torch.observability.events import (
    EventLog,
    mint_run_id,
    observability_enabled,
    read_events,
)
from dct_tpu_torch.observability.heartbeat import (
    HeartbeatMonitor,
    heartbeat_path,
)
from dct_tpu_torch.observability.metrics import MetricsRegistry
from dct_tpu_torch.observability.spans import (
    SpanRecorder,
    env_parent_span_id,
    span_file_name,
    spans_dir_from,
)
from dct_tpu_torch.resilience.supervisor import (
    EXIT_INFRA_CLEANUP,
    EXIT_INFRA_HEALTHCHECK,
    EXIT_PREEMPTED,
    RestartPolicy,
    classify_failure,
)

#: Exit codes of a world the launcher tore down for a revocation that lost
#: nothing durable: a clean exit, a saved-and-exited 75, or our own SIGTERM
#: (a rank still starting, before its guard is up) and the SIGKILL after
#: the grace window.
_REVOKED_CODES = frozenset({0, EXIT_PREEMPTED, -signal.SIGTERM,
                            -signal.SIGKILL})

#: Environment switches of reference planes the port has not ported.
_UNPORTED_PLANES = (
    ("DCT_TS_DIR", "the telemetry-history and anomaly plane"),
)


def _refuse_unported_planes(env: dict) -> None:
    for var, plane in _UNPORTED_PLANES:
        if env.get(var):
            raise ValueError(
                f"{var}={env[var]!r} arms {plane}, which is not ported to "
                "dct_tpu_torch: ROADMAP Queue A item 27. Unset it.")


def _launcher_event_log(env: dict) -> EventLog:
    """The orchestrator-side event log, built from the SAME env the ranks
    inherit, so launcher and rank records land in one file under one
    run-correlation ID (rank=None marks orchestrator records)."""
    events_dir = env.get("DCT_EVENTS_DIR", "logs/events")
    enabled = observability_enabled(env) and bool(events_dir)
    return EventLog(
        os.path.join(events_dir, "events.jsonl") if enabled else None,
        run_id=env["DCT_RUN_ID"], rank=None)


def _launcher_metrics_publisher(env: dict, proc: str):
    """Metrics-plane publisher for the orchestrator side (None when the
    plane is unarmed): the launcher and the supervisor publish into the
    same snapshot dir the trainer and the scheduler do, so one scrape
    sees them all."""
    metrics_dir = env.get("DCT_METRICS_DIR") or ""
    if not metrics_dir or not observability_enabled(env):
        return None
    try:
        interval = float(env.get("DCT_METRICS_PUBLISH_S") or 2.0)
    except ValueError:
        interval = 2.0
    return SnapshotPublisher(MetricsRegistry(), metrics_dir, proc=proc,
                             interval_s=interval)


def _launcher_span_recorder(env: dict) -> SpanRecorder:
    """Orchestrator-side span recorder over the env the ranks inherit: the
    launch span and every rank's spans share one trace."""
    directory = (spans_dir_from(env.get("DCT_EVENTS_DIR", "logs/events"),
                                env.get("DCT_SPANS_DIR", ""))
                 if observability_enabled(env) else None)
    rec = SpanRecorder(
        os.path.join(directory, span_file_name(None)) if directory else None,
        trace_id=env["DCT_RUN_ID"], rank=None)
    # Parent from the merged env the ranks inherit: a caller passing
    # DCT_SPAN_ID through launch(env=...) parents the launch span.
    rec.root_parent = env_parent_span_id(env)
    return rec


def remote_command(exec_template: str, host: str, command: str) -> str:
    """Wrap ``command`` for one host per the quoting contract above:
    the raw command becomes a single quoted ``{cmd}`` token."""
    return exec_template.format(host=host, cmd=shlex.quote(command))


def build_zombie_cleanup_script(
    hosts: list[str],
    *,
    exec_template: str = "ssh {host} {cmd}",
    pattern: str = "dct_tpu_torch.train_job",
    settle_seconds: int = 2,
) -> str:
    """Kill stale ranks on every host before relaunch (the reference's
    rendezvous-port hygiene, dags/2_pytorch_training.py:29-38).

    "No zombies matched" is success (the remote ``|| true``), but a dead
    exec TRANSPORT (ssh/docker unreachable) exits ``EXIT_INFRA_CLEANUP``
    — distinct from a training failure, so the supervisor/operator sees
    "the control plane is broken", not "training crashed again".
    """
    lines = ["echo 'Cleaning up zombie training processes...'"]
    # Bracket the first char so the pattern cannot match the shell that
    # carries it (pkill -f would otherwise kill its own wrapping bash).
    safe_pattern = f"[{pattern[0]}]{pattern[1:]}" if pattern else pattern
    for host in hosts:
        kill = f"pkill -9 -f {shlex.quote(safe_pattern)} || true"
        lines.append(
            remote_command(exec_template, host, kill)
            + " || { echo "
            + shlex.quote(f"Cleanup exec transport failed on {host}")
            + f"; exit {EXIT_INFRA_CLEANUP}; }}"
        )
    lines.append(f"sleep {settle_seconds}")
    lines.append("echo 'Cleanup complete'")
    return "\n".join(lines)


def build_healthcheck_script(
    hosts: list[str],
    *,
    exec_template: str = "ssh {host} {cmd}",
    check_command: str = (
        "python3 -c 'import torch; assert torch.cuda.is_available(); "
        "print(torch.cuda.device_count())'"
    ),
) -> str:
    """Verify every host's runtime imports and sees its cards (the
    default checks that torch sees CUDA; analog of the per-node
    ``import torch`` check,
    dags/2_pytorch_training.py:40-46). ``set -e`` makes any host's failed
    check fail the whole task — without it bash returns the LAST command's
    status and a broken host would slip through to the SPMD launch.

    A failed check exits ``EXIT_INFRA_HEALTHCHECK`` (not the remote
    command's arbitrary status): the supervisor's classifier must see
    "a host is unhealthy" as infra, never as a training crash to burn
    restart budget on.
    """
    lines = ["set -e"]
    for host in hosts:
        lines.append(f"echo 'Checking {host}...'")
        lines.append(
            remote_command(exec_template, host, check_command)
            + " || { echo "
            + shlex.quote(f"Healthcheck failed on {host}")
            + f"; exit {EXIT_INFRA_HEALTHCHECK}; }}"
        )
    lines.append("echo 'All hosts healthy'")
    return "\n".join(lines)


def build_spmd_launch_script(
    hosts: list[str],
    command: str,
    *,
    exec_template: str = "ssh {host} {cmd}",
    coordinator_port: int = 29500,
    stagger_seconds: int = 5,
    extra_env: dict[str, str] | None = None,
    fail_fast_poll_seconds: int = 2,
    run_id: str | None = None,
) -> str:
    """Generate the launch block: same program on every host, coordinator
    env injected, staggered start, fail-fast join, exit-code conjunction.

    Every rank additionally receives the same ``DCT_RUN_ID``
    run-correlation ID, so one grep over the structured event log
    reconstructs the whole launch. The ID is resolved when the script
    RUNS, not when it is built (``run_id`` arg pins it; otherwise the
    runtime environment's ``DCT_RUN_ID``, else minted by the script) —
    Airflow renders BashOperator commands at DAG-parse time, and a
    parse-time mint would be shared by every run of the parsed script.
    The value is spliced into each rank's env as an unquoted ``$RUN_ID``
    expansion OUTSIDE the shlex-quoted command token, so it expands on
    the LAUNCHER host for every exec template (ssh flattens one quoting
    level; the remote shell must never see the bare variable).

    Host 0 is the coordinator (MASTER_ADDR), mirroring the reference env
    contract (docker-compose.yml:121-124) so the same script works under
    both topologies.

    Fail-fast join: the reference ``wait``s each rank sequentially
    (dags/2_pytorch_training.py:62-75), so a dead worker leaves the
    coordinator blocked in a collective until the 3-hour task timeout.
    Here a polling loop reaps ranks as they exit and, on the first nonzero
    exit, terminates the remaining launch processes — the failure surfaces
    in seconds. (For ssh templates the kill stops the local client; any
    orphaned remote rank is covered by the next run's zombie purge, the
    same hygiene model as the reference.)
    """
    world = len(hosts)
    master = hosts[0]
    # Placeholder protocol: the env prefix carries a token that survives
    # shlex.quote unchanged; after quoting, the token is replaced by
    # '"$RUN_ID"' — closing the single-quoted command token, splicing a
    # double-quoted launcher-side expansion, and reopening it. Every
    # exec template therefore ships the RESOLVED id, never the variable.
    _PH = "__DCT_RUN_ID__"
    lines = [
        f"echo 'Launching SPMD training on {world} hosts...'",
        (
            f"RUN_ID={shlex.quote(run_id)}"
            if run_id
            else 'RUN_ID="${DCT_RUN_ID:-dct-$(date +%s)-$$}"'
        ),
        # The splice below expands $RUN_ID OUTSIDE the quoted command
        # token and the remote shell re-parses the result, so the value
        # MUST be shell-inert: strip to the id alphabet (an operator's
        # 'run 2026' or a $(...) would otherwise split or execute on
        # every host), and re-mint if nothing survives.
        "RUN_ID=\"$(printf %s \"$RUN_ID\" | tr -cd 'A-Za-z0-9._-')\"",
        'RUN_ID="${RUN_ID:-dct-$$}"',
        'echo "run_id=$RUN_ID"',
        "set -m",
    ]
    for rank, host in enumerate(hosts):
        env = {
            "MASTER_ADDR": master,
            "MASTER_PORT": str(coordinator_port),
            "NODE_RANK": str(rank),
            "WORLD_SIZE": str(world),
            "DCT_RUN_ID": _PH,
            **(extra_env or {}),
        }
        env_prefix = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        full = f"{env_prefix} {command}"
        launch_line = remote_command(exec_template, host, full).replace(
            _PH, "'\"$RUN_ID\"'"
        )
        lines.append(launch_line + " &")
        lines.append(f"PID{rank}=$!")
        lines.append(f"DONE{rank}=0")
        if rank == 0 and world > 1:
            lines.append(f"sleep {stagger_seconds}")
    ranks = range(world)
    # set -m gives each background job its own process group (PGID = leader
    # PID); kill the GROUP — a plain kill of the wrapper shell is deferred
    # by bash until its foreground child finishes, leaving the actual rank
    # running. Reaped ranks are skipped via their DONE flag.
    lines.append("kill_survivors() {")
    for s in ranks:
        lines.append(
            f'  [ "$DONE{s}" -eq 0 ] && kill -- "-$PID{s}" 2>/dev/null'
        )
    lines.append("  :")
    lines.append("}")
    lines.append("FAILED=0")
    lines.append(f"REMAINING={world}")
    lines.append('while [ "$REMAINING" -gt 0 ]; do')
    for r in ranks:
        lines.extend([
            f'  if [ "$DONE{r}" -eq 0 ] && ! kill -0 "$PID{r}" 2>/dev/null; then',
            f'    wait "$PID{r}"; RC{r}=$?; DONE{r}=1; '
            f"REMAINING=$((REMAINING-1))",
            f'    echo "Rank {r} exited with code $RC{r}"',
            f'    if [ "$RC{r}" -ne 0 ] && [ "$FAILED" -eq 0 ]; then',
            "      FAILED=1",
            '      echo "Rank failure detected - terminating remaining ranks (fail-fast)"',
            "      kill_survivors",
            "    fi",
            "  fi",
        ])
    lines.append(
        f'  [ "$REMAINING" -gt 0 ] && sleep {fail_fast_poll_seconds}'
    )
    lines.append("done")
    conj = " && ".join(f'[ "$RC{r}" -eq 0 ]' for r in ranks)
    # Exit-code classification (resilience.supervisor contract): a rank
    # that exited 75 (EXIT_PREEMPTED) was preempted gracefully; 143 is
    # our own fail-fast SIGTERM (kill_survivors) reaping survivors of
    # the first failure. 137 (SIGKILL) is NOT ours — this script never
    # escalates past SIGTERM — so an OOM-killed rank counts as a hard
    # failure. Only when NO rank failed hard does the script itself exit
    # 75, so Airflow retries (the script-level supervisor) see "resume
    # me" distinctly from "training crashed".
    lines.append("HARD=0; PRE=0")
    for r in ranks:
        lines.append(
            f'case "$RC{r}" in 0|143) ;; 75) PRE=1 ;; *) HARD=1 ;; esac'
        )
    lines.append(
        f'if {conj}; then echo "All {world} ranks finished successfully"; '
        f'else echo "Training failed: rank exit codes: '
        + " ".join(f"$RC{r}" for r in ranks)
        + '"; '
        + 'if [ "$HARD" -eq 0 ] && [ "$PRE" -eq 1 ]; '
        + 'then echo "World preempted - resumable"; exit 75; fi; '
        + "exit 1; fi"
    )
    return "\n".join(lines)


def _kill_group(p: "subprocess.Popen") -> None:
    """SIGKILL a rank's whole process group (falls back to the direct
    child if the group is already gone)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        p.kill()


def _term_group(p: "subprocess.Popen") -> None:
    """SIGTERM a rank's whole process group — the graceful half of the
    SIGTERM -> SIGKILL escalation: a healthy rank's PreemptionGuard gets
    its chance to save a resume checkpoint and exit EXIT_PREEMPTED; a
    wedged one is SIGKILLed when the grace window expires."""
    try:
        os.killpg(p.pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError, OSError):
        p.terminate()


@dataclass
class RankResult:
    rank: int
    returncode: int


@dataclass
class AttemptRecord:
    """One supervised launch attempt and how it ended."""

    attempt: int
    results: list
    classification: str
    wall_seconds: float


@dataclass
class SuperviseResult:
    """Outcome of :meth:`LocalProcessLauncher.supervise`."""

    results: list
    attempts: list = field(default_factory=list)
    restarts: int = 0
    success: bool = False
    classification: str = "crash"


class SupervisorTerminated(Exception):
    """The supervisor itself received SIGTERM/SIGINT: raised from the
    signal handler so launch()'s finally-block teardown runs — the
    ranks live in their own sessions (start_new_session), so a
    supervisor that dies on the default signal disposition would orphan
    them past any task-level process-group kill."""


class LocalProcessLauncher:
    """N local processes running the identical program with coordinator
    env, a staggered start, a fail-fast join and the exit-code
    conjunction; the launcher also mints the run-correlation ID, emits its
    events into the log the ranks write, and watches the ranks'
    heartbeats (reporting by default; killing the world with
    ``stall_kill``)."""

    def __init__(
        self,
        *,
        coordinator_port: int = 29511,
        stagger_seconds: float = 1.0,
        timeout: float = 600.0,
        fail_fast: bool = True,
        poll_seconds: float = 0.2,
        heartbeat_dir: str | None = None,
        heartbeat_stall_seconds: float = 120.0,
        heartbeat_scan_seconds: float = 5.0,
        preempt_grace_s: float = 15.0,
        stall_kill: bool = False,
    ):
        self.coordinator_port = coordinator_port
        self.stagger_seconds = stagger_seconds
        self.timeout = timeout
        self.fail_fast = fail_fast
        self.poll_seconds = poll_seconds
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_stall_seconds = heartbeat_stall_seconds
        self.heartbeat_scan_seconds = heartbeat_scan_seconds
        # SIGTERM -> SIGKILL escalation window: how long a rank being torn
        # down gets to honor its PreemptionGuard (finish the span, save,
        # exit 75) before its group is SIGKILLed.
        self.preempt_grace_s = preempt_grace_s
        self.stall_kill = stall_kill
        # What the last launch() observed, for supervise()'s classifier.
        self._stall_killed = False
        self._timed_out = False
        self._revoked = False

    def _hb_dir(self, env: dict) -> str:
        """The SAME dir ObservabilityConfig defaults the ranks to (they
        inherit this cwd), so the monitor is armed out of the box."""
        return (env.get("DCT_HEARTBEAT_DIR") or self.heartbeat_dir
                or "logs/heartbeats")

    def launch(
        self,
        argv: list[str],
        *,
        world_size: int,
        env: dict[str, str] | None = None,
        preempt_event=None,
    ) -> list[RankResult]:
        procs: list[subprocess.Popen] = []
        self._stall_killed = False
        self._timed_out = False
        self._revoked = False
        base_env = dict(os.environ)
        base_env.update(env or {})
        _refuse_unported_planes(base_env)
        base_env["DCT_RUN_ID"] = base_env.get("DCT_RUN_ID") or mint_run_id()
        if self.heartbeat_dir:
            base_env.setdefault("DCT_HEARTBEAT_DIR", self.heartbeat_dir)
        events = _launcher_event_log(base_env)
        events.emit("launcher", "launch_start", world_size=world_size,
                    argv=list(argv))
        tracer = _launcher_span_recorder(base_env)
        launch_span = tracer.open("launcher.launch", component="launcher",
                                  world_size=world_size)
        rank_spans: dict[int, object] = {}
        # Gated on the switch the ranks honor: with DCT_OBSERVABILITY off
        # no rank beats, and an ungated monitor would call them missing.
        monitor = (
            HeartbeatMonitor(self._hb_dir(base_env), world_size,
                             stall_seconds=self.heartbeat_stall_seconds,
                             run_id=base_env["DCT_RUN_ID"])
            if observability_enabled(base_env) else None)
        # Per-rank PROGRESS age (seconds since step/epoch last advanced:
        # write age alone cannot tell a beating-but-wedged rank from a
        # healthy one) on the metrics plane.
        metrics_pub = (_launcher_metrics_publisher(
            base_env, f"launcher-{os.getpid()}")
            if monitor is not None else None)
        progress_gauge = (metrics_pub.registry.gauge(
            "dct_rank_progress_age_seconds",
            "Seconds since each rank's heartbeat (step, epoch) last "
            "advanced (progress age, not write age).", agg="max")
            if metrics_pub is not None else None)
        flagged: set[tuple[int, str]] = set()
        last_scan = 0.0
        try:
            for rank in range(world_size):
                rank_env = dict(base_env)
                rank_env.update(
                    MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(self.coordinator_port),
                    NODE_RANK=str(rank),
                    WORLD_SIZE=str(world_size),
                    DCT_SPAN_ID=launch_span.span_id,
                )
                rank_spans[rank] = tracer.start(
                    "launcher.rank", component="launcher",
                    parent_id=launch_span.span_id, launched_rank=rank)
                # Own process group per rank, so a kill reaches the rank's
                # whole tree.
                procs.append(subprocess.Popen(argv, env=rank_env,
                                              start_new_session=True))
                if rank == 0 and world_size > 1:
                    time.sleep(self.stagger_seconds)
            codes: dict[int, int] = {}
            killed = False
            kill_deadline = None
            escalated = False

            def _teardown_world() -> None:
                """SIGTERM every surviving group (healthy ranks save and
                exit 75); the poll loop SIGKILLs whatever outlives the
                grace window."""
                nonlocal killed, kill_deadline
                killed = True
                kill_deadline = time.monotonic() + self.preempt_grace_s
                for q in procs:
                    if q.poll() is None:
                        _term_group(q)

            deadline = time.monotonic() + self.timeout
            while len(codes) < world_size and time.monotonic() < deadline:
                progressed = False
                for rank, p in enumerate(procs):
                    if rank in codes:
                        continue
                    rc = p.poll()
                    if rc is None:
                        continue
                    codes[rank] = rc
                    progressed = True
                    rank_spans[rank].end(returncode=rc)
                    events.emit("launcher", "rank_exit", exited_rank=rank,
                                returncode=rc)
                    if rc != 0 and self.fail_fast and not killed:
                        _teardown_world()
                if (preempt_event is not None and preempt_event.is_set()
                        and not killed):
                    # Cooperative preemption (the scheduler's lease
                    # revocation): every rank's PreemptionGuard saves and
                    # exits 75, so the world classifies "preempted" with
                    # its checkpointed progress intact.
                    self._revoked = True
                    _teardown_world()
                if killed and not escalated and (
                        time.monotonic() >= kill_deadline):
                    escalated = True
                    for q in procs:
                        if q.poll() is None:
                            _kill_group(q)
                # Liveness beyond PIDs: a rank can be alive and wedged.
                if monitor is not None and (
                        time.monotonic() - last_scan
                        >= self.heartbeat_scan_seconds):
                    last_scan = time.monotonic()
                    wedged = self._flag_heartbeats(
                        monitor, codes, flagged, events,
                        progress_gauge=progress_gauge,
                        metrics_pub=metrics_pub)
                    if wedged and self.stall_kill and not killed:
                        self._stall_killed = True
                        events.emit(
                            "launcher", "restart.stall_kill",
                            stalled_ranks=wedged,
                            stall_seconds=self.heartbeat_stall_seconds)
                        print(f"[launcher] stall-kill: ranks {wedged} "
                              "wedged; terminating the world for relaunch",
                              file=sys.stderr, flush=True)
                        _teardown_world()
                if not progressed and len(codes) < world_size:
                    time.sleep(self.poll_seconds)
            for rank, p in enumerate(procs):
                if rank not in codes:  # deadline hit
                    # A rank that finished during the last sleep keeps its
                    # real exit code.
                    rc = p.poll()
                    timed_out = rc is None
                    if timed_out:
                        self._timed_out = True
                        _kill_group(p)
                        p.wait()
                        rc = -signal.SIGKILL
                        events.emit("launcher", "rank_timeout_killed",
                                    exited_rank=rank)
                    codes[rank] = rc
                    rank_spans[rank].end(returncode=rc, timeout=timed_out)
            skew = monitor.report() if monitor is not None else {}
            success = all(codes[r] == 0 for r in range(world_size))
            events.emit(
                "launcher", "launch_end",
                returncodes=[codes[r] for r in range(world_size)],
                success=success,
                **{k: skew[k] for k in ("epoch_skew", "step_skew")
                   if k in skew})
            launch_span.end(success=success)
            return [RankResult(rank=r, returncode=codes[r])
                    for r in range(world_size)]
        finally:
            if metrics_pub is not None:
                # Progress age is a LIVE signal: retire the snapshot so a
                # post-run scrape never reads a frozen age as current.
                metrics_pub.close()
            live = [p for p in procs if p.poll() is None]
            if live:
                # Exception-path teardown (supervisor terminated) with the
                # same SIGTERM -> grace -> SIGKILL escalation.
                for p in live:
                    _term_group(p)
                grace_deadline = time.monotonic() + self.preempt_grace_s
                while any(p.poll() is None for p in live) and (
                        time.monotonic() < grace_deadline):
                    time.sleep(0.1)
                for p in live:
                    if p.poll() is None:
                        _kill_group(p)
            # Reap every rank before returning: a relaunch must not start
            # while a killed rank still holds its card's memory.
            for p in procs:
                try:
                    p.wait(timeout=30)
                except (subprocess.TimeoutExpired, OSError):
                    pass
            for sp in rank_spans.values():
                sp.end(error=True)  # no-op for spans already ended
            launch_span.end(error=True)

    def _flag_heartbeats(self, monitor: HeartbeatMonitor, codes: dict,
                         flagged: set, events: EventLog, progress_gauge=None,
                         metrics_pub=None) -> list[int]:
        """One monitor pass: publish each live rank's progress age, and
        warn (stderr + event) once per (rank, state) for stalled or missing
        ranks that have not exited, and once per new epoch-skew level.
        Returns the ranks currently stalled or missing."""
        wedged: list[int] = []
        statuses = monitor.scan()
        if progress_gauge is not None:
            for s in statuses:
                # Done and reaped ranks stop advancing by design: their
                # growing age would page on a healthy completion.
                if (s.progress_age_seconds is not None and s.state != "done"
                        and s.rank not in codes):
                    progress_gauge.set(round(s.progress_age_seconds, 3),
                                       {"rank": s.rank})
            if metrics_pub is not None:
                metrics_pub.maybe_publish()
        for s in statuses:
            if s.rank in codes or s.state not in ("stalled", "missing"):
                continue
            wedged.append(s.rank)
            key = (s.rank, s.state)
            if key in flagged:
                continue
            flagged.add(key)
            age = (f" (last beat {s.age_seconds:.0f}s ago)"
                   if s.age_seconds else "")
            print(f"[launcher] rank {s.rank} heartbeat {s.state}{age}: "
                  "process alive but not progressing"
                  if s.state == "stalled"
                  else f"[launcher] rank {s.rank} has written no heartbeat",
                  file=sys.stderr, flush=True)
            events.emit("launcher", f"rank_{s.state}", flagged_rank=s.rank,
                        age_seconds=s.age_seconds, step=s.step,
                        epoch=s.epoch)
        skew = monitor.skew(statuses)
        if skew["epoch_skew"] > 1 and (
                ("skew", skew["epoch_skew"]) not in flagged):
            flagged.add(("skew", skew["epoch_skew"]))
            print(f"[launcher] straggler skew: ranks span "
                  f"{skew['epoch_skew']} epochs / {skew['step_skew']} steps",
                  file=sys.stderr, flush=True)
            events.emit("launcher", "rank_skew", **skew)
        return wedged

    # ------------------------------------------------------------------
    def supervise(
        self,
        argv: list[str],
        *,
        world_size: int,
        env: dict[str, str] | None = None,
        max_restarts: int = 2,
        backoff_s: float = 1.0,
        backoff_factor: float = 2.0,
        jitter: float = 0.1,
        max_attempts: int = 50,
        sleep_fn=time.sleep,
        clock=time.monotonic,
        preempt_event=None,
    ) -> SuperviseResult:
        """Supervised relaunch-and-resume: run :meth:`launch` until the
        world succeeds, classifying every failure and relaunching
        resumable ones with exponential backoff.

        - ``preempted``: the ranks saved resume checkpoints and exited 75;
          relaunch at once, no restart budget consumed (bounded by
          ``max_attempts``);
        - ``crash`` / ``hang`` / ``infra``: relaunch after the backoff, up
          to ``max_restarts`` times;
        - ``health_halt``: deterministic (the same checkpoint re-diverges),
          so give up at once.

        Every relaunch sets ``DCT_RESUME=1`` and clears ``DCT_FAULT_SPEC``
        (a fault plan is a drill for the first attempt; a resumed world
        would re-fire it forever), and the dead attempt's heartbeat files
        are removed. ``lost_wall_s`` on the ``restart.*`` events is the
        wall clock lost so far: each failed attempt's window since its
        last durable resume checkpoint (its ``resume_state_saved``
        events), plus the backoff.

        SIGTERM/SIGINT to the supervisor raise
        :class:`SupervisorTerminated`, which unwinds through launch()'s
        teardown: the ranks (in their own sessions) are SIGTERMed, save
        and exit 75, and the result is ``preempted``.

        ``preempt_event`` (a :class:`threading.Event`): once set, the world
        is SIGTERMed (the ranks save and exit 75) and a ``preempted``
        attempt returns at once (``supervise_preempted``) instead of the
        free relaunch; the caller's next lease resumes the trajectory. So
        does a revoked world whose ranks died of that SIGTERM (or of the
        SIGKILL after the grace window) before their guards were up.
        """
        base_env = dict(env or {})
        merged = dict(os.environ)
        merged.update(base_env)
        _refuse_unported_planes(merged)
        # One run-correlation ID across every attempt.
        run_id = merged.get("DCT_RUN_ID") or mint_run_id()
        base_env["DCT_RUN_ID"] = merged["DCT_RUN_ID"] = run_id
        events = _launcher_event_log(merged)
        policy = RestartPolicy(max_restarts=max_restarts,
                               backoff_s=backoff_s,
                               backoff_factor=backoff_factor, jitter=jitter)
        events.emit("launcher", "supervise_start", world_size=world_size,
                    max_restarts=max_restarts, argv=list(argv))
        # Restart accounting on the metrics plane, published as a FINAL
        # snapshot when supervision ends (the restart history outlives
        # the supervisor).
        metrics_pub = _launcher_metrics_publisher(
            merged, f"supervisor-{os.getpid()}")
        restarts_ctr = lost_gauge = None
        if metrics_pub is not None:
            restarts_ctr = metrics_pub.registry.counter(
                "dct_restarts_total",
                "Supervised world relaunches, by failure classification.")
            lost_gauge = metrics_pub.registry.gauge(
                "dct_restart_lost_wall_seconds",
                "Wall seconds lost to failed attempts and backoff.",
                agg="sum")
        attempts: list[AttemptRecord] = []
        restarts = 0
        debt = 0.0

        def _raise_terminated(signum, frame):
            raise SupervisorTerminated(f"signal {signum}")

        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev_handlers[sig] = signal.signal(sig, _raise_terminated)
                except (ValueError, OSError):
                    pass
        try:
            while True:
                t0 = clock()
                t0_wall = time.time()
                results = self.launch(argv, world_size=world_size,
                                      env=base_env,
                                      preempt_event=preempt_event)
                wall = clock() - t0
                cls = classify_failure(
                    [r.returncode for r in results],
                    stall_killed=self._stall_killed,
                    timed_out=self._timed_out)
                attempts.append(
                    AttemptRecord(len(attempts) + 1, results, cls, wall))
                if cls == "success":
                    events.emit(
                        "launcher",
                        "restart.recovered" if len(attempts) > 1
                        else "supervise_end",
                        attempts=len(attempts), restarts_used=restarts,
                        lost_wall_s=round(debt, 3))
                    return SuperviseResult(
                        results=results, attempts=attempts,
                        restarts=restarts, success=True, classification=cls)
                if (preempt_event is not None and preempt_event.is_set()
                        and (cls == "preempted" or (self._revoked and all(
                            r.returncode in _REVOKED_CODES
                            for r in results)))):
                    # Lease revocation, not a failure: the world saved and
                    # exited 75 by contract. Returning (instead of the free
                    # relaunch) hands the card back to the grant loop. A
                    # rank our SIGTERM met before its guard was up died of
                    # it with nothing to save: that world is revoked too,
                    # not a crash to relaunch into the same revocation
                    # (which the reference does until its budget is spent).
                    events.emit("launcher", "supervise_preempted",
                                attempts=len(attempts),
                                restarts_used=restarts)
                    return SuperviseResult(
                        results=results, attempts=attempts,
                        restarts=restarts, success=False,
                        classification="preempted")
                if not policy.allows(restarts, cls) or (
                        len(attempts) >= max_attempts):
                    events.emit(
                        "launcher", "restart.gave_up", classification=cls,
                        restarts_used=restarts, attempts=len(attempts),
                        returncodes=[r.returncode for r in results])
                    return SuperviseResult(
                        results=results, attempts=attempts,
                        restarts=restarts, success=False,
                        classification=cls)
                consume = cls != "preempted"
                delay = policy.delay(restarts) if consume else 0.0
                if consume:
                    restarts += 1
                debt += self._attempt_lost_seconds(
                    merged, run_id, cls, t0_wall, wall) + delay
                self._clear_heartbeats(merged, world_size)
                if restarts_ctr is not None:
                    restarts_ctr.inc(1, {"classification": cls})
                    lost_gauge.set(round(debt, 3))
                    metrics_pub.publish()
                events.emit(
                    "launcher", "restart.relaunch",
                    attempt=len(attempts) + 1, classification=cls,
                    backoff_s=round(delay, 3), lost_wall_s=round(debt, 3),
                    restarts_used=restarts,
                    returncodes=[r.returncode for r in results])
                base_env["DCT_RESUME"] = "1"
                base_env["DCT_FAULT_SPEC"] = ""
                if delay > 0:
                    sleep_fn(delay)
        except SupervisorTerminated:
            # launch()'s finally already tore the world down.
            events.emit("launcher", "supervise_terminated",
                        attempts=len(attempts), restarts_used=restarts)
            return SuperviseResult(
                results=attempts[-1].results if attempts else [],
                attempts=attempts, restarts=restarts, success=False,
                classification="preempted")
        finally:
            if metrics_pub is not None:
                metrics_pub.close(final=True)
            for sig, prev in prev_handlers.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass

    @staticmethod
    def _attempt_lost_seconds(env: dict, run_id: str, classification: str,
                              t0_wall: float, wall: float) -> float:
        """Wall clock the failed attempt LOST: the window since its last
        durable resume checkpoint. A graceful preemption saved at the
        boundary by contract: zero. No save seen: the whole attempt."""
        if classification == "preempted":
            return 0.0
        saves = [r["ts"] for r in read_events(
            env.get("DCT_EVENTS_DIR") or "logs/events")
            if r.get("run_id") == run_id
            and r.get("event") == "resume_state_saved"
            and r.get("ts", 0.0) >= t0_wall]
        if not saves:
            return wall
        return min(wall, max(0.0, t0_wall + wall - max(saves)))

    def _clear_heartbeats(self, env: dict, world_size: int) -> None:
        """Drop the dead attempt's heartbeat files: they carry the SAME run
        ID as the relaunch, so the fresh monitor would read them as
        instantly stalled ranks."""
        hb_dir = self._hb_dir(env)
        for rank in range(world_size):
            try:
                os.remove(heartbeat_path(hb_dir, rank))
            except OSError:
                pass

    @staticmethod
    def all_succeeded(results: list[RankResult]) -> bool:
        return all(r.returncode == 0 for r in results)
