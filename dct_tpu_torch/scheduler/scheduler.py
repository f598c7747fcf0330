"""Multi-tenant workload scheduler: N always-on loops sharing one card
(counterpart of ``dct_tpu/scheduler/scheduler.py``).

The :class:`~dct_tpu_torch.continuous.loop.AlwaysOnLoop` babysits ONE
workload; this supervisor runs a roster of them concurrently against
shared hardware. Each tenant is a full always-on loop (its own run dirs,
deploy registry, endpoint slots and ``DCT_RUN_ID`` namespace under
``<DCT_SCHED_ROOT>/<name>/``) whose ingest watcher and promotion evaluator
run continuously (host-side work), while TRAINING ROUNDS time-share the
card through round leases:

- before each round the tenant's loop blocks on the scheduler's grant
  gate; grants follow strict priority class then weighted deficit
  (:mod:`dct_tpu_torch.scheduler.quota`), so chip time converges to the
  configured quota shares at the loop's natural preemption point, round
  boundaries;
- a starved higher-class waiter preempts a running lower-class round
  through the graceful-preemption path (the trainer checkpoints and the
  round ends early; progress is never lost): an inline round through its
  guard's ``request()``, a supervised round through the launcher's
  ``preempt_event`` (the ranks are SIGTERMed and exit 75);
- fault isolation rides the supervisor's exit-code classifier: one
  tenant's crash is healed by ITS round's supervisor; a health halt or an
  exhausted restart budget PARKS that tenant (``tenant.parked``) while
  every other tenant's supervisor, watcher and evaluator keep running;
- every tenant loads the one kernel build under ``build/dct_tpu_torch/``
  (``ops/build.py``; ``sched.start`` records the directory): the second
  tenant builds nothing. The reference pins a shared compile/AOT store
  here (``DCT_SCHED_SHARED_CACHE``); the port has none (ROADMAP Queue A
  item 18), so the switch sets no environment.

Port differences: ``device=`` goes to every tenant's loop (``cuda:0``
unless the caller asks for the CPU; a supervised round's ranks get
``DCT_DEVICE=cpu`` from the loop on the CPU and take ``cuda:<rank>`` on
the card); each tenant's supervised worlds rendezvous on their own
``MASTER_PORT`` (29531 + the tenant's index); ``DCT_TS_DIR`` (the
reference's anomaly monitor over the telemetry history) raises naming
ROADMAP Queue A item 27.

Inline tenants are threads of this process: their trainers and gate
engines share one CUDA context, and ``faults.set_default`` is
process-wide, which is why an inline tenant with ``DCT_FAULT_SPEC`` is
refused.

Observability: ``sched.*`` / ``tenant.*`` events on the scheduler's log,
per-tenant training telemetry on each tenant's own log, and the per-tenant
goodput/badput/chip-time/round-wait ledger published under a ``tenant``
label on the aggregated metrics plane (``DCT_METRICS_DIR``; the terminal
snapshot is ``final`` so one scrape after a drain still reads the
session's quota account).

Shutdown: SIGTERM (via ``python -m dct_tpu_torch.scheduler_job``) or
``request_stop()`` drains every tenant (in-flight rounds finish, each loop
runs its own final evaluator sweep), then emits ``sched.stop`` with the
quota report. A relaunch resumes every tenant's trajectory and champion.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from dct_tpu_torch.config import RunConfig
from dct_tpu_torch.scheduler.quota import QuotaLedger
from dct_tpu_torch.scheduler.spec import TenantSpec, TenantSpecError, parse_tenants

#: Round-wait histogram buckets (seconds): lease waits run from
#: sub-second (idle card) to minutes (behind a healing round).
WAIT_BUCKETS = (0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 240.0, 900.0)

#: Coordinator ports for per-tenant supervised worlds: each tenant's
#: launcher gets its own port so concurrent leases never collide on
#: the rendezvous socket.
_BASE_COORDINATOR_PORT = 29531


@contextlib.contextmanager
def _env_overlay(overlay: dict):
    """Temporarily overlay ``os.environ`` (tenant config construction
    reuses ``RunConfig.from_env`` — THE parser — instead of a second,
    driftable path). Only used serially at scheduler startup."""
    saved = {k: os.environ.get(k) for k in overlay}
    try:
        os.environ.update({k: str(v) for k, v in overlay.items()})
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class TenantRuntime:
    """One tenant's live state inside the scheduler."""

    def __init__(self, spec: TenantSpec, *, root: str, run_id: str):
        self.spec = spec
        self.name = spec.name
        self.root = root
        self.run_id = run_id
        self.env: dict[str, str] = {}
        self.cfg: RunConfig | None = None
        self.loop = None
        self.thread: threading.Thread | None = None
        # pending -> waiting -> running -> idle -> ... -> stopped|parked
        self.state = "pending"
        self.chips = 1
        self.wait_started: float | None = None
        self.lease_t0: float | None = None
        self.preempt_sent = False
        self.summary: dict | None = None
        self.parked_reason: str | None = None


class WorkloadScheduler:
    """The grant loop + tenant supervisors (module docstring).

    ``cfg`` carries the scheduler knobs (``cfg.sched``) and the
    scheduler's OWN observability sinks; ``tenants`` overrides the
    roster (default: parsed from ``cfg.sched.spec`` / ``DCT_TENANTS``).
    ``base_env`` is a dict of DCT_* defaults applied under every
    tenant's config overlay before its own ``env`` (tests and benches
    shrink polls/soaks for the whole roster with it). ``device`` is the
    tenants' device (``cuda:0`` when None)."""

    def __init__(
        self,
        cfg: RunConfig | None = None,
        *,
        tenants: list[TenantSpec] | None = None,
        base_env: dict | None = None,
        clock=time.time,
        device=None,
    ):
        from dct_tpu_torch.device import resolve_device
        from dct_tpu_torch.observability.events import current_run_id

        self.cfg = cfg if cfg is not None else RunConfig.from_env()
        self.sched_cfg = self.cfg.sched
        self._clock = clock
        self._base_env = dict(base_env or {})
        self.run_id = self.cfg.obs.run_id or current_run_id()
        self.events = self._event_log()
        self.ledger = QuotaLedger()
        self._cond = threading.Condition()
        self._active: set[str] = set()
        self._stopping = False
        self.stop_reason: str | None = None
        self.total_rounds = 0
        self.preempts = 0
        self._t0: float | None = None
        self._runtimes: dict[str, TenantRuntime] = {}
        self._threads: list[threading.Thread] = []
        self._monitor: threading.Thread | None = None
        self._metrics = None
        self._publisher = None
        if tenants is None:
            tenants = parse_tenants(self.sched_cfg.spec)
        if not tenants:
            raise TenantSpecError("scheduler needs at least one tenant")
        self.tenants = tenants
        self.device = resolve_device(device)

    # -- construction ---------------------------------------------------
    def _event_log(self):
        from dct_tpu_torch.observability.events import EventLog

        path = (
            os.path.join(self.cfg.obs.events_dir, "events.jsonl")
            if self.cfg.obs.enabled and self.cfg.obs.events_dir
            else None
        )
        return EventLog(path, run_id=self.run_id)

    def _init_metrics(self) -> None:
        if not self.cfg.obs.metrics_dir:
            return
        from dct_tpu_torch.observability.aggregate import SnapshotPublisher
        from dct_tpu_torch.observability.metrics import MetricsRegistry

        reg = MetricsRegistry()
        self._metrics = {
            "chip_s": reg.counter(
                "dct_tenant_chip_seconds_total",
                "Chip-seconds granted to each tenant's round leases "
                "(lease wall x tenant chips) — the quota account.",
            ),
            "goodput_s": reg.counter(
                "dct_tenant_goodput_seconds_total",
                "Useful training seconds inside each tenant's leases.",
            ),
            "badput_s": reg.counter(
                "dct_tenant_badput_seconds_total",
                "Lease seconds lost to healing/restarts per tenant.",
            ),
            "rounds": reg.counter(
                "dct_tenant_rounds_total",
                "Round leases completed per tenant, by outcome.",
            ),
            "restarts": reg.counter(
                "dct_tenant_restarts_total",
                "Supervised in-round relaunches per tenant (the "
                "supervisor healing inside that tenant's lease).",
            ),
            "wait": reg.histogram(
                "dct_tenant_round_wait_seconds",
                "Seconds each tenant waited for a round lease.",
                buckets=WAIT_BUCKETS,
            ),
            "goodput_frac": reg.gauge(
                "dct_tenant_goodput_fraction",
                "Per-tenant goodput fraction over granted lease time.",
                agg="last",
            ),
            "quota_share": reg.gauge(
                "dct_tenant_quota_share",
                "Configured chip-time share (weight / sum of weights).",
                agg="last",
            ),
            "granted_share": reg.gauge(
                "dct_tenant_granted_share",
                "Actual chip-time share granted so far.",
                agg="last",
            ),
            "parked": reg.gauge(
                "dct_tenant_parked",
                "1 while the tenant is parked (crash budget exhausted "
                "or health halt); 0 otherwise.",
                agg="max",
            ),
            "preempts": reg.counter(
                "dct_sched_preempts_total",
                "Graceful round preemptions, labelled by the preempted "
                "tenant.",
            ),
        }
        self._publisher = SnapshotPublisher(
            reg,
            self.cfg.obs.metrics_dir,
            proc=f"scheduler-{os.getpid()}",
            interval_s=self.cfg.obs.metrics_publish_s,
            clock=self._clock,
        )

    def _build_runtime(self, spec: TenantSpec, index: int) -> TenantRuntime:
        from dct_tpu_torch.continuous.loop import AlwaysOnLoop

        troot = os.path.join(self.sched_cfg.root, spec.name)
        rt = TenantRuntime(
            spec, root=troot, run_id=f"{self.run_id}-{spec.name}"
        )
        assigned = {
            "DCT_RUN_ID": rt.run_id,
            "DCT_PROCESSED_DIR": os.path.join(troot, "processed"),
            "DCT_MODELS_DIR": os.path.join(troot, "models"),
            "DCT_EVENTS_DIR": os.path.join(troot, "events"),
            "DCT_HEARTBEAT_DIR": os.path.join(troot, "heartbeats"),
            "DCT_LOOP_PACKAGES_DIR": os.path.join(troot, "packages"),
            "DCT_LOOP_ENDPOINT": spec.resolved_endpoint(),
        }
        if spec.family:
            assigned["DCT_MODEL"] = spec.family
        # Spec validation already rejects reserved keys, so the merge
        # order only decides base_env vs spec.env (tenant wins).
        rt.env = {**self._base_env, **spec.env, **assigned}
        with _env_overlay(rt.env):
            rt.cfg = RunConfig.from_env()
        rt.chips = max(1, int(rt.env.get("DCT_WORLD_SIZE") or
                              os.environ.get("DCT_WORLD_SIZE") or 1))
        if rt.cfg.resilience.fault_spec and rt.cfg.loop.train_mode != "supervised":
            # An inline crash fault is os._exit — it would take the
            # whole scheduler (and every peer tenant) down with it.
            raise TenantSpecError(
                f"tenant {spec.name!r}: DCT_FAULT_SPEC requires "
                "DCT_LOOP_TRAIN_MODE=supervised under the scheduler"
            )
        rt.loop = AlwaysOnLoop(
            rt.cfg,
            device=self.device,
            round_gate=lambda rt=rt: self._acquire(rt),
            on_round=lambda rec, rt=rt: self._on_round(rt, rec),
            extra_round_env=rt.env,
            launcher_kwargs={
                "coordinator_port": _BASE_COORDINATOR_PORT + index,
            },
        )
        self.ledger.register(
            spec.name, weight=spec.weight,
            priority_rank=spec.priority_rank, chips=rt.chips,
        )
        return rt

    # -- grant machinery ------------------------------------------------
    def _best_waiter(self) -> TenantRuntime | None:
        waiters = [
            t for t in self._runtimes.values() if t.state == "waiting"
        ]
        name = self.ledger.pick([t.name for t in waiters])
        return self._runtimes[name] if name else None

    def _acquire(self, rt: TenantRuntime) -> bool:
        """The tenant loop's round gate: block until a lease is granted
        (True) or the tenant/session is draining (False)."""
        with self._cond:
            rt.state = "waiting"
            rt.wait_started = self._clock()
            self._cond.notify_all()
            while True:
                if self._stopping or rt.loop.stopping:
                    rt.state = "draining"
                    self._cond.notify_all()
                    return False
                if (
                    len(self._active) < self.sched_cfg.concurrent
                    and self._best_waiter() is rt
                ):
                    wait_s = self._clock() - rt.wait_started
                    rt.state = "running"
                    rt.lease_t0 = self._clock()
                    rt.preempt_sent = False
                    self._active.add(rt.name)
                    self.ledger.record_grant(rt.name, wait_s)
                    m = self._metrics
                    if m is not None:
                        m["wait"].observe(wait_s, {"tenant": rt.name})
                    self.events.emit(
                        "sched", "sched.grant",
                        tenant=rt.name, wait_s=round(wait_s, 3),
                        deficit=round(self.ledger.deficit(rt.name), 3),
                        active=sorted(self._active),
                    )
                    return True
                self._cond.wait(0.2)

    def _on_round(self, rt: TenantRuntime, rec: dict) -> None:
        """Lease release at the round boundary (the loop's on_round)."""
        self._release(rt, rec)

    def _release(self, rt: TenantRuntime, rec: dict | None) -> None:
        with self._cond:
            if rt.name not in self._active:
                return
            wall_s = self._clock() - (rt.lease_t0 or self._clock())
            rec = rec or {}
            preempted = bool(rec.get("preempted"))
            outcome = "preempted" if preempted else (
                "error" if rec.get("error") else "ok"
            )
            goodput_s = rec.get("goodput_s")
            if goodput_s is None and outcome != "ok":
                # An errored round (or an inline preemption, whose
                # trainer result is lost) must not book its whole wall
                # as goodput — a chronically failing tenant would read
                # as perfectly efficient. Unmeasured non-ok leases book
                # ZERO goodput; supervised records carry the measured
                # attempt wall either way.
                goodput_s = 0.0
            booked = self.ledger.record_release(
                rt.name, wall_s=wall_s,
                goodput_s=goodput_s, preempted=preempted,
            )
            self._active.discard(rt.name)
            rt.state = "idle"
            self.total_rounds += 1
            restarts = int(rec.get("restarts") or 0)
            m = self._metrics
            if m is not None:
                lab = {"tenant": rt.name}
                m["chip_s"].inc(booked["chip_s"], lab)
                m["goodput_s"].inc(booked["goodput_s"], lab)
                m["badput_s"].inc(booked["badput_s"], lab)
                m["rounds"].inc(1, {"tenant": rt.name, "outcome": outcome})
                if restarts:
                    m["restarts"].inc(restarts, lab)
                frac = self.ledger.tenants[rt.name].goodput_fraction
                if frac is not None:
                    m["goodput_frac"].set(round(frac, 4), lab)
                self._refresh_share_gauges()
                if self._publisher is not None:
                    self._publisher.maybe_publish()
            self.events.emit(
                "sched", "sched.release",
                tenant=rt.name, outcome=outcome, restarts=restarts,
                **booked,
            )
            if (
                self.sched_cfg.max_rounds
                and self.total_rounds >= self.sched_cfg.max_rounds
            ):
                self._request_stop_locked("max_rounds")
            self._cond.notify_all()

    def _refresh_share_gauges(self) -> None:
        m = self._metrics
        if m is None:
            return
        for name in self.ledger.tenants:
            lab = {"tenant": name}
            m["quota_share"].set(
                round(self.ledger.fair_share(name), 4), lab
            )
            gs = self.ledger.granted_share(name)
            if gs is not None:
                m["granted_share"].set(round(gs, 4), lab)

    # -- starvation preemption + budgets (monitor thread) ---------------
    def _monitor_body(self) -> None:
        while True:
            with self._cond:
                if self._stopping:
                    return
                self._cond.wait(self.sched_cfg.poll_s)
                if self._stopping:
                    return
                if (
                    self.sched_cfg.max_wall_s
                    and self._t0 is not None
                    and self._clock() - self._t0 >= self.sched_cfg.max_wall_s
                ):
                    self._request_stop_locked("max_wall_s")
                    return
                victim = self._preemption_check()
            if victim is not None:
                # Outside the lock: preempt_round touches the victim
                # loop's own (independent) synchronization.
                victim.loop.preempt_round()
            if self._publisher is not None:
                self._publisher.maybe_publish()

    def _preemption_check(self) -> TenantRuntime | None:
        """Under the lock: name a victim for a starved, strictly
        higher-class waiter (quota.preemption_victim), once per lease."""
        if self.sched_cfg.preempt_wait_s <= 0:
            return None
        best = self._best_waiter()
        if best is None or best.wait_started is None:
            return None
        if self._clock() - best.wait_started < self.sched_cfg.preempt_wait_s:
            return None
        victim_name = self.ledger.preemption_victim(
            best.name, sorted(self._active)
        )
        if victim_name is None:
            return None
        victim = self._runtimes[victim_name]
        if victim.preempt_sent:
            return None
        victim.preempt_sent = True
        self.preempts += 1
        if self._metrics is not None:
            self._metrics["preempts"].inc(1, {"tenant": victim_name})
        self.events.emit(
            "sched", "sched.preempt",
            tenant=victim_name, waiter=best.name,
            waited_s=round(self._clock() - best.wait_started, 3),
        )
        return victim

    # -- tenant threads --------------------------------------------------
    def _run_tenant(self, rt: TenantRuntime) -> None:
        try:
            rt.summary = rt.loop.run()
        except Exception as e:  # noqa: BLE001 — one tenant's crash must not unwind the others
            rt.summary = {
                "reason": "runtime_error",
                "error": f"{type(e).__name__}: {e}"[:300],
            }
        finally:
            self._release(rt, {"error": rt.summary and rt.summary.get("error")})
        reason = str(rt.summary.get("reason") or "")
        error = rt.summary.get("error")
        # The loop's terminal reasons carry the supervisor's classifier:
        # "train_health_halt" / "train_crash" / "train_hang" = the
        # supervisor gave up inside a round; "train_error" = an inline
        # round raised. All park the tenant; a drain does not.
        parked = bool(error) or reason.startswith("train_")
        with self._cond:
            if parked and not self._stopping:
                rt.state = "parked"
                rt.parked_reason = reason or "error"
                classification = (
                    reason[len("train_"):] if reason.startswith("train_")
                    else "error"
                )
                if self._metrics is not None:
                    self._metrics["parked"].set(1, {"tenant": rt.name})
                    if self._publisher is not None:
                        self._publisher.maybe_publish()
                self.events.emit(
                    "tenant", "tenant.parked",
                    tenant=rt.name, classification=classification,
                    reason=reason, error=error,
                )
            else:
                rt.state = "stopped"
            self.events.emit(
                "tenant", "tenant.stop",
                tenant=rt.name, reason=reason or None, error=error,
                rounds=rt.summary.get("rounds"),
                promotions=rt.summary.get("promotions"),
                held=rt.summary.get("held"),
            )
            self._cond.notify_all()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        """Build every tenant (serially — config construction overlays
        the process env), then start their threads + the monitor."""
        from dct_tpu_torch.ops.build import BUILD_DIR

        if os.environ.get("DCT_TS_DIR"):
            raise ValueError(
                f"DCT_TS_DIR={os.environ['DCT_TS_DIR']!r} arms the "
                "telemetry-history and anomaly plane, which is not ported "
                "to dct_tpu_torch: ROADMAP Queue A item 27. Unset it.")
        self._t0 = self._clock()
        self._init_metrics()
        for i, spec in enumerate(self.tenants):
            self._runtimes[spec.name] = self._build_runtime(spec, i)
        self.events.emit(
            "sched", "sched.start",
            tenants=[
                {
                    "name": s.name, "family": s.family, "weight": s.weight,
                    "priority": s.priority,
                    "endpoint": s.resolved_endpoint(),
                }
                for s in self.tenants
            ],
            concurrent=self.sched_cfg.concurrent,
            preempt_wait_s=self.sched_cfg.preempt_wait_s,
            shared_cache=self.sched_cfg.shared_cache,
            kernel_build_dir=BUILD_DIR,
            root=self.sched_cfg.root,
            device=str(self.device),
        )
        self._refresh_share_gauges()
        for rt in self._runtimes.values():
            self.events.emit(
                "tenant", "tenant.start",
                tenant=rt.name, run_id=rt.run_id, root=rt.root,
                family=rt.cfg.model.name, weight=rt.spec.weight,
                priority=rt.spec.priority, chips=rt.chips,
                train_mode=rt.cfg.loop.train_mode,
            )
            t = threading.Thread(
                target=self._run_tenant, args=(rt,),
                name=f"tenant-{rt.name}", daemon=True,
            )
            rt.thread = t
            t.start()
            self._threads.append(t)
        self._monitor = threading.Thread(
            target=self._monitor_body, name="sched-monitor", daemon=True,
        )
        self._monitor.start()

    def request_stop(self, reason: str = "requested") -> None:
        with self._cond:
            self._request_stop_locked(reason)

    def _request_stop_locked(self, reason: str) -> None:
        if self.stop_reason is None:
            self.stop_reason = reason
        self._stopping = True
        for rt in self._runtimes.values():
            if rt.loop is not None:
                rt.loop.request_stop(f"scheduler_{reason}")
        self._cond.notify_all()

    @property
    def stopping(self) -> bool:
        return self._stopping

    def run(self) -> dict:
        """start() + block until every tenant thread finished (a parked
        tenant's thread HAS finished — parked is a terminal state the
        operator resolves), then drain and return the summary."""
        self.start()
        try:
            while True:
                alive = [t for t in self._threads if t.is_alive()]
                if not alive:
                    break
                # Short joins keep the main thread signal-responsive
                # (jobs/scheduler.py's SIGTERM handler runs here).
                alive[0].join(timeout=0.5)
        finally:
            summary = self.close()
        return summary

    def close(self) -> dict:
        """Drain: stop every loop (in-flight rounds finish), join, emit
        ``sched.stop``, leave a final metrics snapshot behind."""
        with self._cond:
            if self.stop_reason is None:
                self.stop_reason = "completed"
            self._request_stop_locked(self.stop_reason)
        # One deadline for the whole drain: a tenant thread still inside a
        # round (or a CUDA call) cannot hold the job past it.
        deadline = time.monotonic() + 300.0
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
        summary = self.summary()
        self.events.emit("sched", "sched.stop", **summary)
        if self._publisher is not None:
            self._refresh_share_gauges()
            self._publisher.close(final=True)
        return summary

    def summary(self) -> dict:
        report = self.ledger.report()
        tenants = {}
        for name, rt in self._runtimes.items():
            entry = dict(report.get(name, {}))
            entry["state"] = rt.state
            if rt.parked_reason:
                entry["parked_reason"] = rt.parked_reason
            if rt.summary:
                entry["promotions"] = rt.summary.get("promotions")
                entry["loop_reason"] = rt.summary.get("reason")
                entry["error"] = rt.summary.get("error")
            tenants[name] = entry
        return {
            "reason": self.stop_reason,
            "wall_s": (
                round(self._clock() - self._t0, 3)
                if self._t0 is not None else None
            ),
            "total_rounds": self.total_rounds,
            "preempts": self.preempts,
            "tenants": tenants,
        }
