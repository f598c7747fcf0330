"""Always-on loop entry point: ``python -m dct_tpu_torch.loop_job``
(counterpart of ``jobs/loop.py``).

Runs :class:`dct_tpu_torch.continuous.loop.AlwaysOnLoop` from the ``DCT_*``
environment (``DCT_LOOP_*`` knobs; ``DCT_LOOP_TRAIN_MODE`` is
``supervised`` by default: each round is a ``python -m
dct_tpu_torch.train_job`` world under the supervisor; ``inline`` trains in
this process) until SIGTERM/SIGINT or a stop budget
(``DCT_LOOP_MAX_ROUNDS`` / ``_MAX_WALL_S`` / ``_MAX_PROMOTIONS``). The
rounds and the gate's accelerator engine run on ``cuda:0``, or on the CPU
with ``DCT_DEVICE=cpu``.

SIGTERM drains. During a round the round owns the signal: a supervised
round's supervisor forwards it to the world (the ranks finish their span,
save a resume snapshot and exit 75), an inline round's trainer stops at its
next step or span with a durable resume snapshot; the loop stops with
reason ``preempted``. Between rounds this process's handler asks the loop
to stop before the next round. Either way the ingest and
evaluator threads join, one final evaluator sweep covers the last
published checkpoint, and the process exits 0. A relaunch resumes the
trajectory and the deployed champion.

Prints one ``[loop_job] summary {...}`` JSON line. Exit code: 0 on a clean
drain (SIGTERM and stop budgets included), 1 when the loop stopped on an
error (a supervised round gave up); a refused mode or device raises (exit
1 with its traceback).
"""

from __future__ import annotations

import json
import os
import signal
import sys


def main() -> int:
    from dct_tpu_torch.config import RunConfig
    from dct_tpu_torch.continuous.loop import AlwaysOnLoop

    cfg = RunConfig.from_env()
    loop = AlwaysOnLoop(cfg, device=os.environ.get("DCT_DEVICE") or None)
    print(f"[loop_job] starting: run_id={loop.run_id} "
          f"mode={cfg.loop.train_mode} "
          f"device={loop.device} endpoint={cfg.loop.endpoint} "
          f"epochs/round={cfg.loop.epochs_per_round}", flush=True)

    def _drain(signum, frame):
        # A round in flight owns the signal (the supervisor's handler or
        # the trainer's guard) and restores this handler after.
        print(f"[loop_job] signal {signum}: draining before the next round",
              flush=True)
        loop.request_stop(f"signal_{signum}")

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _drain)

    summary = loop.run()
    print(f"[loop_job] summary {json.dumps(summary)}", flush=True)
    return 1 if summary.get("error") else 0


if __name__ == "__main__":
    sys.exit(main())
