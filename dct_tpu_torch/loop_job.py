"""Always-on loop entry point: ``python -m dct_tpu_torch.loop_job``
(counterpart of ``jobs/loop.py``).

Runs :class:`dct_tpu_torch.continuous.loop.AlwaysOnLoop` from the ``DCT_*``
environment (``DCT_LOOP_*`` knobs: ``DCT_LOOP_TRAIN_MODE`` must be
``inline``, ``supervised`` raising until ROADMAP Queue A item 20 is
ported) until SIGTERM/SIGINT or a stop budget (``DCT_LOOP_MAX_ROUNDS`` /
``_MAX_WALL_S`` / ``_MAX_PROMOTIONS``). The rounds and the gate's
accelerator engine run on ``cuda:0``, or on the CPU with ``DCT_DEVICE=cpu``.

SIGTERM drains: the round in flight finishes and publishes its
checkpoints, the ingest and evaluator threads join, one final evaluator
sweep covers the last published checkpoint, and the process exits 0. A
relaunch resumes the trajectory and the deployed champion.

Prints one ``[loop_job] summary {...}`` JSON line. Exit code: 0 on a clean
drain (SIGTERM and stop budgets included), 1 when the loop stopped on an
error; a refused mode or device raises (exit 1 with its traceback).
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
    print(f"[loop_job] starting: mode={cfg.loop.train_mode} "
          f"device={loop.device} endpoint={cfg.loop.endpoint} "
          f"epochs/round={cfg.loop.epochs_per_round}", flush=True)

    def _drain(signum, frame):
        print(f"[loop_job] signal {signum}: draining after the round in "
              "flight", flush=True)
        loop.request_stop(f"signal_{signum}")

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _drain)

    summary = loop.run()
    print(f"[loop_job] summary {json.dumps(summary)}", flush=True)
    return 1 if summary.get("error") else 0


if __name__ == "__main__":
    sys.exit(main())
