"""Multi-tenant scheduler entry point: ``python -m
dct_tpu_torch.scheduler_job`` (counterpart of ``jobs/scheduler.py``).

Runs :class:`dct_tpu_torch.scheduler.WorkloadScheduler` from the ``DCT_*``
environment: the tenant roster from ``DCT_TENANTS`` (inline JSON or a
tenants.json path), the arbitration knobs from ``DCT_SCHED_*``, until
SIGTERM/SIGINT, a stop budget (``DCT_SCHED_MAX_WALL_S`` /
``_MAX_ROUNDS``), or every tenant reaching a terminal state. The tenants
train and gate on ``cuda:0``, or on the CPU with ``DCT_DEVICE=cpu``.

SIGTERM drains: every tenant's in-flight round finishes (or checkpoints
under its own supervisor), each loop runs its final evaluator sweep, and
the process exits with ``sched.stop`` on the scheduler's event log. A
relaunch resumes every tenant's trajectory and deployed champion.

Prints one ``[scheduler_job] summary {...}`` JSON line, then this process's
flash-kernel launch counts (``[scheduler_job] launches {...}``: its inline
tenants' rounds and every tenant's gate engine; a supervised round's ranks
print their own) and the kernel libraries it loaded, each with whether this
process built it (``[scheduler_job] kernels {...}``). Exit code: 0 on a
clean drain (SIGTERM and budgets included) with no tenant parked; 1 when a
tenant parked (restart budget exhausted, health halt) or errored; 2 when
the roster was rejected (the offending clause named, nothing launched).
"""

from __future__ import annotations

import json
import os
import signal
import sys


def main() -> int:
    from dct_tpu_torch.scheduler import TenantSpecError, WorkloadScheduler

    try:
        sched = WorkloadScheduler(device=os.environ.get("DCT_DEVICE") or None)
    except TenantSpecError as e:
        print(f"[scheduler_job] tenant spec rejected: {e}", file=sys.stderr,
              flush=True)
        return 2
    print(f"[scheduler_job] starting: run_id={sched.run_id} "
          f"tenants={[t.name for t in sched.tenants]} "
          f"concurrent={sched.sched_cfg.concurrent} "
          f"root={sched.sched_cfg.root} device={sched.device}", flush=True)

    def _drain(signum, frame):
        print(f"[scheduler_job] signal {signum}: draining all tenants",
              flush=True)
        sched.request_stop(f"signal_{signum}")

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _drain)

    try:
        summary = sched.run()
    except TenantSpecError as e:
        # Per-tenant validation that needs the built config (an inline
        # fault drill) rejects at start(): same contract as a malformed
        # roster.
        print(f"[scheduler_job] tenant spec rejected: {e}", file=sys.stderr,
              flush=True)
        return 2
    parked = sorted(name for name, t in summary["tenants"].items()
                    if t.get("state") == "parked" or t.get("error"))
    from dct_tpu_torch.ops import build
    from dct_tpu_torch.ops.flash_attention import launch_counts

    print(f"[scheduler_job] summary {json.dumps(summary)}", flush=True)
    print(f"[scheduler_job] launches {json.dumps(launch_counts())}",
          flush=True)
    print("[scheduler_job] kernels " + json.dumps({
        name: {"path": info["path"], "built": info["built"]}
        for name, info in build.build_info.items()}), flush=True)
    print(f"[scheduler_job] stopped: reason={summary['reason']} "
          f"rounds={summary['total_rounds']} preempts={summary['preempts']} "
          f"parked={parked or 'none'}", flush=True)
    return 1 if parked else 0


if __name__ == "__main__":
    sys.exit(main())
