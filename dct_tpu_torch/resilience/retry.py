"""``with_retries``: backoff + jitter + transient-vs-fatal classification
(a copy of ``Retrier`` and ``with_retries``, ``dct_tpu/resilience/
retry.py:40-133``; the rest of the reference's resilience package is
ROADMAP Queue A item 28).

Every control-plane call of the rollout (and the evaluator's) goes through
one retry policy, so a transient flake costs a backoff sleep instead of a
cycle. Only *transient* failures retry: ``classify`` decides (default
:func:`is_transient`: connection and timeout error types, plus a
name/message heuristic for SDK-wrapped 5xx and throttle errors). A fatal
error raises at once.
"""

from __future__ import annotations

import random
import time

#: Substrings (lowercased ``TypeName: message``) that mark an exception
#: transient when its type alone does not — SDKs wrap timeouts and 5xxs
#: in their own exception classes (mlflow's RestException, requests'
#: wrappers), so the type check cannot be exhaustive.
_TRANSIENT_MARKERS = (
    "timeout", "timed out", "connection", "unavailable", "temporar",
    "reset by peer", "refused", "bad gateway", "too many requests",
    "throttl", "503", "502", "504", "econnreset", "broken pipe",
)


def is_transient(exc: BaseException) -> bool:
    """Default classifier: retry network-ish failures, nothing else."""
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _TRANSIENT_MARKERS)


class Retrier:
    """A reusable retry policy: ``retrier(fn, op="log_metrics")`` calls
    ``fn()`` up to ``max_attempts`` times with exponential backoff."""

    def __init__(
        self,
        *,
        max_attempts: int = 3,
        backoff_s: float = 0.5,
        backoff_factor: float = 2.0,
        jitter: float = 0.1,
        classify=is_transient,
        sleep_fn=time.sleep,
        rng=random.random,
    ):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.jitter = float(jitter)
        self.classify = classify
        self.sleep_fn = sleep_fn
        self.rng = rng

    @classmethod
    def from_env(cls, env=None, **overrides) -> "Retrier":
        """Policy from ``DCT_RETRY_MAX_ATTEMPTS`` / ``DCT_RETRY_BACKOFF_S``
        (for layers without config plumbing, e.g. the tracking client)."""
        import os

        env = env if env is not None else os.environ
        kw = dict(
            max_attempts=int(env.get("DCT_RETRY_MAX_ATTEMPTS") or 3),
            backoff_s=float(env.get("DCT_RETRY_BACKOFF_S") or 0.5),
        )
        kw.update(overrides)
        return cls(**kw)

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based failed attempts)."""
        base = self.backoff_s * self.backoff_factor ** (attempt - 1)
        return base * (1.0 + self.jitter * self.rng())

    def __call__(self, fn, *, op: str = "call"):
        # ``op`` names the call; the reference's retry.attempt and
        # retry.exhausted events on it are ROADMAP Queue A item 27.
        last: BaseException | None = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                last = e
                if not self.classify(e) or attempt >= self.max_attempts:
                    raise
                self.sleep_fn(self.delay(attempt))
        raise last  # unreachable; keeps type-checkers honest


def with_retries(
    fn,
    *,
    op: str = "call",
    max_attempts: int = 3,
    backoff_s: float = 0.5,
    backoff_factor: float = 2.0,
    jitter: float = 0.1,
    classify=is_transient,
    sleep_fn=time.sleep,
):
    """One-shot form: run ``fn()`` under a fresh :class:`Retrier`."""
    return Retrier(
        max_attempts=max_attempts,
        backoff_s=backoff_s,
        backoff_factor=backoff_factor,
        jitter=jitter,
        classify=classify,
        sleep_fn=sleep_fn,
    )(fn, op=op)
