"""Deterministic fault injection: the ``DCT_FAULT_SPEC`` fault plan (a
copy of ``dct_tpu/resilience/faults.py``).

Every failure mode the supervisor must heal — a crashed rank, a wedged
collective, a NaN'd loss, a save torn mid-write — needs a reproducible
trigger before the healing is testable. The plan is parsed from one env
var so the SAME spec drives a unit test, a launched multi-process rig,
and a chaos job in CI.

Spec grammar (comma-separated clauses)::

    DCT_FAULT_SPEC = clause[,clause...]
    clause         = ACTION[@rankR|@procR][:TRIGGER]
    TRIGGER        = epochN | stepN | saveN | reqN | msM

``@procR`` is the serving spelling of ``@rankR`` (a ServerPool child's
pool index rides the same rank slot — the pool exports it as
``DCT_PROCESS_ID`` into each forked worker).

Actions and the hook points that consult them:

===========  =========  ====================================================
action       point      behavior when fired
===========  =========  ====================================================
crash        epoch/step ``os._exit(FAULT_CRASH_EXIT)`` — a hard rank death
                        (no atexit, no finally; the launcher sees a nonzero
                        exit). Epoch-trigger crashes first join any pending
                        resume-checkpoint write (the ``pre_exit`` hook) so
                        the resume point is deterministic; use
                        ``crash_save`` to exercise torn-write recovery.
hang         epoch/step sleep forever — the rank stays PID-alive but stops
                        beating, exactly the wedged-collective case the
                        heartbeat monitor (and the supervisor's stall-kill)
                        exists for.
nan          data       the caller poisons the staged batch with NaN, so
                        the loss goes non-finite through the REAL compute
                        path (health.py then warns or halts per policy).
slow_save    save       sleep ``DCT_FAULT_SLEEP_S`` inside the checkpoint
                        write window (tmp written, final not yet renamed) —
                        widens the torn-write window so a test can kill the
                        process mid-save.
crash_save   save       ``os._exit`` inside the same window — the torn
                        save itself: only ``*.tmp`` debris may remain.
slow_epoch   epoch      sleep ``DCT_FAULT_SLEEP_S`` at epoch start — makes
                        "SIGTERM arrives mid-epoch" deterministic in tests.
crash_worker score      ``os._exit(FAULT_CRASH_EXIT)`` inside the serving
                        micro-batcher's flush path — a serving worker
                        process dying mid-traffic, the case the ServerPool's
                        self-healing respawn exists for (docs/SERVING.md).
                        ``:reqN`` fires at the Nth scored logical request
                        (default: the first). NOTE: in a no-fork in-process
                        server this kills the host process — arm it only
                        against forked pools.
slow_score   score      sleep inside every flush — deterministic overload
                        (the knee moves wherever the test wants it).
                        ``:msM`` sets the per-flush sleep in milliseconds
                        (default ``DCT_FAULT_SLEEP_S``). Unlike every other
                        action this clause REPEATS: it fires on every
                        flush, with ``fault.injected`` emitted only once.
===========  =========  ====================================================

Trigger semantics: ``epochN`` fires when epoch index N starts; ``stepN``
fires at the first step hook with global step >= N; ``saveN`` fires on
the Nth call of the save hook in this process (both checkpoint tiers
share the counter); ``reqN`` fires at the first score hook with
cumulative scored-request count >= N; ``msM`` is a PARAMETER, not a
trigger (the ``slow_score`` sleep in milliseconds); no trigger = the
first opportunity. ``@rankR``/``@procR`` restricts the clause to one
rank / pool worker (default: every one). Each clause fires at most once
per process — except ``slow_score``, which repeats by design (it models
a persistently slow scorer, not a one-shot glitch).

Like the rest of the observability plane, the default plan is resolved
lazily from the environment (:func:`get_default`) so layers without
config plumbing (the checkpoint manager) consult the same plan the
trainer installed. An empty/unset spec is a no-op plan.

Hook points wired in the port: ``epoch`` and ``step`` (the trainer),
``data`` (the trainer's staging), ``save`` (both checkpoint tiers) and
``score`` (the serving micro-batcher's flush), so every action of the
grammar fires.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass

from dct_tpu_torch.observability import events as _events
from dct_tpu_torch.observability.events import _rank_from_env

#: Exit code of an injected ``crash`` — distinct from real failures so
#: the event log names the death as injected; the supervisor still
#: classifies it as an ordinary crash (that is the point of the drill).
FAULT_CRASH_EXIT = 117

#: action -> hook points allowed to fire it.
_ACTION_POINTS = {
    "crash": ("epoch", "step"),
    "hang": ("epoch", "step"),
    "nan": ("data",),
    "slow_save": ("save",),
    "crash_save": ("save",),
    "slow_epoch": ("epoch",),
    "crash_worker": ("score",),
    "slow_score": ("score",),
}

#: Actions that fire on EVERY matching hook call instead of once.
_REPEATING_ACTIONS = ("slow_score",)

_CLAUSE_RE = re.compile(
    r"^(?P<action>[a-z_]+)"
    r"(?:@(?:rank|proc)(?P<rank>\d+))?"
    r"(?::(?P<trigger>epoch|step|save|req|ms)(?P<at>\d+))?$"
)


@dataclass
class FaultClause:
    action: str
    rank: int | None = None      # None = any rank
    trigger: str | None = None   # epoch | step | save | None (= first)
    at: int | None = None
    raw: str = ""
    fired: bool = False

    @property
    def repeats(self) -> bool:
        return self.action in _REPEATING_ACTIONS

    def matches(self, point: str, rank: int | None, coords: dict) -> bool:
        if point not in _ACTION_POINTS[self.action]:
            return False
        if self.fired and not self.repeats:
            return False
        if self.rank is not None and rank is not None and self.rank != rank:
            return False
        if self.trigger is None or self.trigger == "ms":
            # ``ms`` is the slow_score sleep parameter, not a trigger.
            return True
        value = coords.get(self.trigger)
        if value is None:
            return False
        # step/req triggers fire on REACHING the count (the exact value
        # may be skipped by accumulation/batch granularity); epoch and
        # save ordinals are exact.
        if self.trigger in ("step", "req"):
            return int(value) >= self.at
        return int(value) == self.at


class FaultPlan:
    """The parsed plan, bound to one rank. ``check`` matches without
    side effects beyond the fired flag + the ``fault.injected`` event;
    ``maybe_fire`` also executes self-executing actions (crash / hang /
    the sleeps)."""

    def __init__(
        self,
        clauses: list[FaultClause] | None = None,
        *,
        rank: int | None = None,
        sleep_s: float = 3.0,
        sleep_fn=time.sleep,
    ):
        self.clauses = list(clauses or [])
        self.rank = rank
        self.sleep_s = float(sleep_s)
        self._sleep = sleep_fn
        self._counts: dict[str, int] = {}

    # -- construction ---------------------------------------------------
    @classmethod
    def parse(
        cls, spec: str, *, rank: int | None = None, sleep_s: float = 3.0
    ) -> "FaultPlan":
        clauses = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            m = _CLAUSE_RE.match(part)
            if m is None or m.group("action") not in _ACTION_POINTS:
                raise ValueError(
                    f"Unparseable fault clause {part!r}; grammar: "
                    "ACTION[@rankR|@procR][:epochN|stepN|saveN|reqN|msM] "
                    f"with ACTION in {sorted(_ACTION_POINTS)}"
                )
            action, trigger = m.group("action"), m.group("trigger")
            if trigger == "ms" and action != "slow_score":
                raise ValueError(
                    f"Fault clause {part!r}: :msM is the slow_score "
                    "sleep parameter, not a trigger"
                )
            if trigger == "req" and "score" not in _ACTION_POINTS[action]:
                raise ValueError(
                    f"Fault clause {part!r}: :reqN only triggers "
                    "serving-side (score-point) actions"
                )
            clauses.append(
                FaultClause(
                    action=m.group("action"),
                    rank=int(m.group("rank")) if m.group("rank") else None,
                    trigger=m.group("trigger"),
                    at=int(m.group("at")) if m.group("at") else None,
                    raw=part,
                )
            )
        return cls(clauses, rank=rank, sleep_s=sleep_s)

    @classmethod
    def from_env(cls, env=None) -> "FaultPlan":
        env = env if env is not None else os.environ
        return cls.parse(
            env.get("DCT_FAULT_SPEC", ""),
            rank=_rank_from_env(),
            sleep_s=float(env.get("DCT_FAULT_SLEEP_S") or 3.0),
        )

    @property
    def enabled(self) -> bool:
        return bool(self.clauses)

    @property
    def fired_count(self) -> int:
        return sum(1 for c in self.clauses if c.fired)

    # -- hook surface ---------------------------------------------------
    def check(self, point: str, **coords) -> FaultClause | None:
        """Match (and mark fired) the first armed clause for ``point``.
        ``save`` ordinals are counted here so callers stay stateless."""
        if not self.clauses:
            return None
        if point == "save":
            self._counts["save"] = self._counts.get("save", 0) + 1
            coords.setdefault("save", self._counts["save"])
        # A repeating clause (slow_score) matches EVERY call at its
        # point: first-match-wins would permanently shadow any one-shot
        # clause listed after it ("slow_score,crash_worker:req50" would
        # never crash). One-shot matches therefore take priority; the
        # repeating clause covers every call they don't claim.
        matched = [
            c for c in self.clauses
            if c.matches(point, self.rank, coords)
        ]
        if not matched:
            return None
        one_shot = [c for c in matched if not c.repeats]
        clause = (one_shot or matched)[0]
        already_fired = clause.fired
        clause.fired = True
        # On the record BEFORE the fault acts: a crash must not be able
        # to outrun its own evidence. Repeating clauses (slow_score)
        # emit once — a per-flush disk append would itself distort the
        # overload they model.
        if not already_fired:
            _events.get_default().emit(
                "fault", "fault.injected",
                action=clause.action, point=point, spec=clause.raw,
                injected_rank=self.rank,
                **{k: v for k, v in coords.items() if v is not None},
            )
        return clause

    def maybe_fire(self, point: str, *, pre_exit=None, **coords):
        """``check`` + execute. ``pre_exit`` runs before a ``crash``
        exits (the trainer joins its in-flight resume save so the crash
        leaves a deterministic resume point). Returns the clause for
        caller-executed actions (``nan``), None otherwise."""
        clause = self.check(point, **coords)
        if clause is None:
            return None
        # The fault.injected record is already on disk: the port's event
        # log writes each record before emit returns, so nothing is left
        # to flush before ``os._exit`` or a hang.
        if clause.action == "crash":
            if pre_exit is not None:
                try:
                    pre_exit()
                except Exception:  # noqa: BLE001 — exit anyway: it's a crash
                    pass
            os._exit(FAULT_CRASH_EXIT)
        if clause.action in ("crash_save", "crash_worker"):
            os._exit(FAULT_CRASH_EXIT)
        if clause.action == "hang":
            while True:  # PID-alive, progress-dead: the monitor's case
                self._sleep(60.0)
        if clause.action == "slow_score":
            # :msM parameterizes the per-flush sleep; default falls back
            # to the plan-wide DCT_FAULT_SLEEP_S like the other sleeps.
            self._sleep(
                clause.at / 1e3 if clause.trigger == "ms" and clause.at
                else self.sleep_s
            )
            return None
        if clause.action in ("slow_save", "slow_epoch"):
            self._sleep(self.sleep_s)
            return None
        return clause  # nan: the caller poisons its staged arrays


# ----------------------------------------------------------------------
# Process-default plan, mirroring events.get_default(): the trainer
# installs its config-built plan; layers without config plumbing (the
# checkpoint manager) resolve the same instance so save ordinals and
# fired flags are shared. Standalone processes parse the env lazily.

_explicit: FaultPlan | None = None
_cached: tuple[tuple, FaultPlan] | None = None

_ENV_KEYS = ("DCT_FAULT_SPEC", "DCT_FAULT_SLEEP_S", "DCT_PROCESS_ID", "NODE_RANK")


def set_default(plan: FaultPlan | None) -> None:
    global _explicit
    _explicit = plan


def get_default() -> FaultPlan:
    global _cached
    if _explicit is not None:
        return _explicit
    key = tuple(os.environ.get(k) for k in _ENV_KEYS)
    if _cached is not None and _cached[0] == key:
        return _cached[1]
    try:
        plan = FaultPlan.from_env()
    except ValueError:
        # A malformed ambient spec must not crash layers that merely
        # consult the plan; the trainer's explicit parse stays loud.
        plan = FaultPlan()
    _cached = (key, plan)
    return plan
