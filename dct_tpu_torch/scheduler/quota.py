"""Chip-time quota ledger and the round-lease grant policy (a copy of
``dct_tpu/scheduler/quota.py``).

The scheduler's unit of arbitration is the ROUND LEASE: one tenant's
permission to run one training round on the shared chips. Grants are
decided by **strict priority class, then weighted deficit**:

- among the waiting tenants, the best (lowest) priority class wins;
- within a class, the tenant with the smallest *deficit* —
  ``granted_chip_seconds / weight`` — wins (deterministic name
  tie-break), so long-run granted chip time converges to each tenant's
  ``weight / sum(weights)`` share regardless of per-round duration
  (a tenant whose round ran long — supervisor healing, bigger model —
  simply waits until the others catch up);
- the policy is work-conserving: free capacity is never held back for
  a tenant that is not asking (an only waiter is granted immediately).

Starvation preemption: when the best waiter outranks every running
tenant's class and has waited past ``preempt_wait_s``, the most-junior
running tenant (worst class, then largest deficit) is named the victim.
The scheduler preempts that round through the graceful-preemption
path — the trainer finishes its in-flight step, makes the resume
snapshot durable, and the round ends early with zero lost progress —
so priority costs a checkpoint boundary, never work.

The ledger also carries the per-tenant goodput/badput split (useful
seconds vs healing/overhead inside granted leases) and the round-wait
series — the numbers the ``tenant``-labelled metrics and the quota
acceptance check read.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TenantLedger:
    """One tenant's chip-time account."""

    weight: float = 1.0
    priority_rank: int = 1
    chips: int = 1
    granted_chip_s: float = 0.0
    goodput_s: float = 0.0
    badput_s: float = 0.0
    rounds: int = 0
    preempted_rounds: int = 0
    waits_s: list = field(default_factory=list)

    @property
    def deficit(self) -> float:
        """Granted chip time normalized by weight — the fair-queueing
        virtual time. Lower = more underserved."""
        return self.granted_chip_s / self.weight

    @property
    def goodput_fraction(self) -> float | None:
        total = self.goodput_s + self.badput_s
        return (self.goodput_s / total) if total > 0 else None

    @property
    def mean_wait_s(self) -> float | None:
        return (
            sum(self.waits_s) / len(self.waits_s) if self.waits_s else None
        )


class QuotaLedger:
    """The roster-wide account + grant arithmetic. NOT thread-safe on
    its own — the scheduler mutates it under its grant lock."""

    def __init__(self):
        self.tenants: dict[str, TenantLedger] = {}

    def register(
        self, name: str, *, weight: float, priority_rank: int,
        chips: int = 1,
    ) -> TenantLedger:
        t = TenantLedger(
            weight=float(weight), priority_rank=int(priority_rank),
            chips=max(1, int(chips)),
        )
        self.tenants[name] = t
        return t

    # -- accounting ----------------------------------------------------
    def record_grant(self, name: str, wait_s: float) -> None:
        self.tenants[name].waits_s.append(max(0.0, float(wait_s)))

    def record_release(
        self, name: str, *, wall_s: float, goodput_s: float | None = None,
        preempted: bool = False,
    ) -> dict:
        """Book one finished lease; returns the booked numbers (the
        event/metric payload). ``goodput_s`` is the useful train wall
        inside the lease (None = the whole lease counts as goodput —
        a supervised round with zero restarts)."""
        t = self.tenants[name]
        wall_s = max(0.0, float(wall_s))
        good = wall_s if goodput_s is None else min(wall_s, max(0.0, goodput_s))
        chip_s = wall_s * t.chips
        t.granted_chip_s += chip_s
        t.goodput_s += good
        t.badput_s += wall_s - good
        t.rounds += 1
        if preempted:
            t.preempted_rounds += 1
        return {
            "wall_s": round(wall_s, 3),
            "chip_s": round(chip_s, 3),
            "goodput_s": round(good, 3),
            "badput_s": round(wall_s - good, 3),
        }

    # -- queries -------------------------------------------------------
    def deficit(self, name: str) -> float:
        return self.tenants[name].deficit

    def fair_share(self, name: str, active: list[str] | None = None) -> float:
        """Configured share among ``active`` tenants (default: all)."""
        names = list(active) if active is not None else list(self.tenants)
        total = sum(self.tenants[n].weight for n in names)
        return self.tenants[name].weight / total if total > 0 else 0.0

    def granted_share(self, name: str) -> float | None:
        total = sum(t.granted_chip_s for t in self.tenants.values())
        if total <= 0:
            return None
        return self.tenants[name].granted_chip_s / total

    # -- policy --------------------------------------------------------
    def pick(self, waiters: list[str]) -> str | None:
        """The next grant among ``waiters``: strict priority class, then
        lowest deficit, then name (deterministic)."""
        if not waiters:
            return None
        return min(
            waiters,
            key=lambda n: (
                self.tenants[n].priority_rank, self.tenants[n].deficit, n
            ),
        )

    def preemption_victim(
        self, waiter: str, running: list[str],
    ) -> str | None:
        """The running tenant a starved ``waiter`` may preempt: only
        tenants of a strictly WORSE class are eligible (equal-class
        starvation is resolved by deficit at the next boundary, not by
        preemption); the most junior — worst class, largest deficit —
        pays."""
        wrank = self.tenants[waiter].priority_rank
        victims = [
            n for n in running if self.tenants[n].priority_rank > wrank
        ]
        if not victims:
            return None
        return max(
            victims,
            key=lambda n: (
                self.tenants[n].priority_rank, self.tenants[n].deficit, n
            ),
        )

    def report(self) -> dict:
        """The per-tenant account as one JSON-able dict (``sched.stop``
        payload / scheduler summary)."""
        out = {}
        for name, t in self.tenants.items():
            out[name] = {
                "weight": t.weight,
                "priority_rank": t.priority_rank,
                "chips": t.chips,
                "rounds": t.rounds,
                "preempted_rounds": t.preempted_rounds,
                "granted_chip_s": round(t.granted_chip_s, 3),
                "goodput_s": round(t.goodput_s, 3),
                "badput_s": round(t.badput_s, 3),
                "goodput_fraction": (
                    round(t.goodput_fraction, 4)
                    if t.goodput_fraction is not None else None
                ),
                "mean_wait_s": (
                    round(t.mean_wait_s, 3)
                    if t.mean_wait_s is not None else None
                ),
                "fair_share": round(self.fair_share(name), 4),
                "granted_share": (
                    round(self.granted_share(name), 4)
                    if self.granted_share(name) is not None else None
                ),
            }
        return out
