"""Graceful preemption: the rank-side SIGTERM contract (a copy of
``dct_tpu/resilience/preempt.py``).

Cluster schedulers reclaim hosts with a SIGTERM and a grace window; a
trainer without this contract dies mid-step and loses everything since
its last checkpoint. The contract here:

1. SIGTERM sets a flag (:class:`PreemptionGuard` — the handler does
   NOTHING else: event/span emitters take locks the interrupted main
   thread may hold, so all I/O happens later at a safe point);
2. the trainer finishes the in-flight step/span, makes the resume
   checkpoint durable (joining the async writer), emits
   ``preempt.signal_received`` + ``preempt.checkpoint_saved``, and
   raises :class:`PreemptedError`;
3. the entry point maps that to ``EXIT_PREEMPTED`` (75), which the
   supervisor classifies as resumable-not-failed: relaunch with resume,
   no restart budget consumed.

The guard installs only on the main thread (Python delivers signals
there; on another thread only :meth:`request` sets it) and always
restores the previous handler, so nested rigs (pytest, Airflow workers)
keep their own SIGTERM semantics.
"""

from __future__ import annotations

import signal
import threading
import time


class PreemptedError(RuntimeError):
    """Training stopped cooperatively on SIGTERM with a durable resume
    checkpoint — resumable-not-failed; map to ``EXIT_PREEMPTED``."""


class PreemptionGuard:
    def __init__(self, *, clock=time.time):
        self._clock = clock
        self.requested = False
        self.signal_time: float | None = None
        self._prev = None
        self._installed = False

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self  # signals never arrive here; stay a no-op guard
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except (ValueError, OSError):
            pass  # embedded interpreter without signal support
        return self

    def _handler(self, signum, frame):
        # Async-signal-safe by construction: two attribute writes, no
        # locks, no I/O. Everything observable happens at the trainer's
        # next safe point.
        self.requested = True
        self.signal_time = self._clock()

    def request(self) -> None:
        """Programmatic preemption: the multi-tenant scheduler's lease
        revocation (:mod:`dct_tpu_torch.scheduler`). Sets the SAME flag the
        SIGTERM handler sets, so the trainer's safe-point contract (finish
        the step or span, durable snapshot, :class:`PreemptedError`) is
        identical; callable from any thread (plain attribute writes, like
        the handler)."""
        self.requested = True
        self.signal_time = self._clock()

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        try:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
        except (ValueError, OSError):
            pass
