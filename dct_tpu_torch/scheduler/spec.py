"""Tenant spec: the declarative roster of workloads sharing one card (a copy
of ``dct_tpu/scheduler/spec.py``: the same grammar, reserved keys and
error messages).

``DCT_TENANTS`` names the roster either INLINE (a JSON array / object —
the value starts with ``[`` or ``{``) or as a path to a ``tenants.json``
file. Shape::

    [
      {"name": "alpha", "family": "weather_mlp", "weight": 2.0,
       "priority": "high",
       "env": {"DCT_LOOP_EPOCHS_PER_ROUND": "1"}},
      {"name": "beta", "weight": 1.0}
    ]

(or ``{"tenants": [...]}``). Fields:

``name``      required; the tenant's identity everywhere — run-dir
              subtree, ``tenant`` metric label, ``DCT_RUN_ID`` suffix,
              default endpoint name. ``[A-Za-z0-9][A-Za-z0-9_-]*``,
              unique per roster.
``family``    registry model name (``DCT_MODEL``); default = the base
              config's family. Every tenant loads the one kernel build
              under ``build/dct_tpu_torch/``.
``weight``    chip-time quota weight (> 0, default 1.0). Long-run
              granted chip time converges to ``weight / sum(weights)``
              within a priority class.
``priority``  ``high`` | ``normal`` | ``low`` (default ``normal``).
              Strict at grant time: a waiting higher class is granted
              before any lower class; a starved higher class may
              PREEMPT a running lower-class round at the graceful
              checkpoint boundary (``DCT_SCHED_PREEMPT_WAIT_S``).
``env``       per-tenant ``DCT_*`` config overrides (fault drills,
              round quantum, optimizer knobs, ...). Scheduler-assigned
              keys (run dirs, run ID, resume plumbing) are RESERVED —
              a spec naming one is rejected at parse time, not
              silently shadowed.
``endpoint``  local endpoint the tenant promotes into (default: the
              tenant name).

Validation is strict and front-loaded: a malformed roster fails the
scheduler at startup with a :class:`TenantSpecError` naming the clause,
never mid-session with one tenant silently misconfigured.
"""

from __future__ import annotations

import json
import math
import os
import re
from dataclasses import dataclass, field

#: Priority classes, best first. Grant order is strict across classes;
#: quota weights share chip time within a class.
PRIORITIES = ("high", "normal", "low")
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_-]{0,63}$")

#: Env keys a tenant spec may NOT override: the scheduler assigns them
#: (isolation would silently break), or they are supervisor plumbing
#: the loop/relauncher owns. ``DCT_SCHED_*`` / ``DCT_TENANTS`` are
#: rejected by prefix — a tenant must not reconfigure its scheduler.
RESERVED_ENV = frozenset({
    "DCT_RUN_ID",
    "DCT_RESUME",
    "DCT_EPOCHS",
    "DCT_PROCESSED_DIR",
    "DCT_MODELS_DIR",
    "DCT_EVENTS_DIR",
    "DCT_HEARTBEAT_DIR",
    "DCT_LOOP_PACKAGES_DIR",
    "DCT_LOOP_ENDPOINT",
    "DCT_STARTUP_RECOVERY_DEBT_S",
})
_RESERVED_PREFIXES = ("DCT_SCHED_", "DCT_TENANTS")


class TenantSpecError(ValueError):
    """A tenant roster that must not reach the grant loop."""


@dataclass
class TenantSpec:
    """One tenant's declaration (module docstring for field semantics)."""

    name: str
    family: str | None = None
    weight: float = 1.0
    priority: str = "normal"
    env: dict = field(default_factory=dict)
    endpoint: str | None = None

    @property
    def priority_rank(self) -> int:
        """Numeric class rank, best (high) = 0 — the grant sort key."""
        return _PRIORITY_RANK[self.priority]

    def resolved_endpoint(self) -> str:
        return self.endpoint or self.name


def _validate_one(raw: dict, index: int) -> TenantSpec:
    where = f"tenant[{index}]"
    if not isinstance(raw, dict):
        raise TenantSpecError(f"{where}: expected an object, got {type(raw).__name__}")
    unknown = set(raw) - {"name", "family", "weight", "priority", "env", "endpoint"}
    if unknown:
        raise TenantSpecError(f"{where}: unknown field(s) {sorted(unknown)}")
    name = raw.get("name")
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise TenantSpecError(
            f"{where}: 'name' must match {_NAME_RE.pattern!r} (got {name!r})"
        )
    where = f"tenant {name!r}"
    family = raw.get("family")
    if family is not None and (not isinstance(family, str) or not family):
        raise TenantSpecError(f"{where}: 'family' must be a non-empty string")
    try:
        weight = float(raw.get("weight", 1.0))
    except (TypeError, ValueError):
        raise TenantSpecError(f"{where}: 'weight' must be a number") from None
    if not (math.isfinite(weight) and weight > 0):
        raise TenantSpecError(f"{where}: 'weight' must be finite and > 0 (got {weight})")
    priority = str(raw.get("priority", "normal")).strip().lower()
    if priority not in PRIORITIES:
        raise TenantSpecError(
            f"{where}: 'priority' must be one of {PRIORITIES} (got {priority!r})"
        )
    env_raw = raw.get("env", {})
    if not isinstance(env_raw, dict):
        raise TenantSpecError(f"{where}: 'env' must be an object of DCT_* strings")
    env: dict[str, str] = {}
    for k, v in env_raw.items():
        if not isinstance(k, str) or not k.startswith("DCT_"):
            raise TenantSpecError(f"{where}: env key {k!r} must be a DCT_* string")
        if k in RESERVED_ENV or any(k.startswith(p) for p in _RESERVED_PREFIXES):
            raise TenantSpecError(
                f"{where}: env key {k!r} is scheduler-assigned (reserved)"
            )
        env[k] = str(v)
    if family is not None and "DCT_MODEL" in env:
        raise TenantSpecError(
            f"{where}: set the family via 'family' OR env DCT_MODEL, not both"
        )
    endpoint = raw.get("endpoint")
    if endpoint is not None and (
        not isinstance(endpoint, str) or not endpoint
    ):
        raise TenantSpecError(f"{where}: 'endpoint' must be a non-empty string")
    return TenantSpec(
        name=name, family=family, weight=weight, priority=priority,
        env=env, endpoint=endpoint,
    )


def parse_tenants(raw: str) -> list[TenantSpec]:
    """Parse a ``DCT_TENANTS`` value (inline JSON or a tenants.json
    path) into a validated roster."""
    if not raw or not raw.strip():
        raise TenantSpecError("DCT_TENANTS is empty: no tenants declared")
    text = raw.strip()
    if not text.startswith(("[", "{")):
        try:
            with open(text) as f:
                text = f.read()
        except OSError as e:
            raise TenantSpecError(f"cannot read tenant spec file {raw!r}: {e}") from e
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise TenantSpecError(f"tenant spec is not valid JSON: {e}") from e
    if isinstance(doc, dict):
        doc = doc.get("tenants")
    if not isinstance(doc, list) or not doc:
        raise TenantSpecError(
            "tenant spec must be a non-empty JSON array "
            "(or {'tenants': [...]})"
        )
    specs = [_validate_one(item, i) for i, item in enumerate(doc)]
    names = [s.name for s in specs]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise TenantSpecError(f"duplicate tenant name(s): {dupes}")
    return specs


def tenants_from_env(env=None) -> list[TenantSpec]:
    """The process's roster, from ``DCT_TENANTS``."""
    raw = (env if env is not None else os.environ).get("DCT_TENANTS", "")
    return parse_tenants(raw)
