"""Dynamic micro-batching and the torch scorer (counterpart of
``dct_tpu/serving/batching.py``).

Handler threads validate and enqueue; scoring workers drain the queue,
merging in-flight requests into one forward of up to ``max_batch`` rows,
waiting at most ``window_ms`` past the oldest queued request for
co-arrivals (0 = whatever is queued when a worker frees up). A request
always flushes whole; one larger than ``max_batch`` flushes alone.

:class:`TorchScorer` is the port of the reference's jitted scorer
(``_build_jax_scorer``): the registry model rebuilt from the package meta
on one device, each flush padded to the next power of two by repeating
its last row, the causal family answered for the window's last position,
and a bf16 package run at bf16 compute with its parameters resident in
bf16 (its stored values are bf16-exact). An f32 package runs in full f32:
its scorer turns TF32 off for CUDA matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``, process-wide).
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque

import numpy as np
import torch


class ScoringError(RuntimeError):
    """A server-side scoring failure (HTTP 500: the request was valid)."""


class TorchScorer:
    """Batched scorer for one package on one device: ``scorer(x)`` maps a
    validated ``[N, S, F]`` f32 array to ``[N, C]`` probabilities
    (``[N, horizon, C]`` for a multi-horizon causal package).
    ``forwards`` counts model forwards (one per flush)."""

    def __init__(self, weights: dict, meta: dict, device):
        from dct_tpu_torch.convert import load_flax_weights
        from dct_tpu_torch.models.registry import (
            config_from_meta,
            get_model,
            is_causal_model,
        )

        self.device = torch.device(device)
        qdtype = (meta.get("quant") or {}).get("dtype")
        if qdtype not in (None, "bf16"):
            raise NotImplementedError(
                f"{qdtype} packages are not ported to dct_tpu_torch yet "
                "(ROADMAP Queue A: int8 packages)"
            )
        self.dtype = torch.bfloat16 if qdtype == "bf16" else torch.float32
        if self.dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        cfg = config_from_meta(meta)
        self.model = get_model(cfg, device=self.device, dtype=self.dtype)
        load_flax_weights(self.model, weights)
        self.model.eval().requires_grad_(False)
        self.causal = is_causal_model(cfg.name)
        self.forwards = 0
        # One forward at a time per device: concurrent flushes would only
        # interleave on the same card and multiply activation memory.
        self._lock = threading.Lock()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        padded = 1
        while padded < n:
            padded *= 2
        if padded != n:
            x = np.concatenate([x, np.repeat(x[-1:], padded - n, axis=0)])
        with self._lock, torch.inference_mode():
            xb = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            logits = self.model(xb.to(self.device))
            if self.causal:
                # [B, S, C] or [B, S, H, C]: answer for the last position.
                logits = logits[:, -1]
            probs = torch.softmax(logits.float(), dim=-1)[:n].cpu().numpy()
            self.forwards += 1
        return probs


class _Request:
    __slots__ = ("x", "t", "done", "probs", "error")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.t = time.monotonic()
        self.done = threading.Event()
        self.probs: np.ndarray | None = None
        self.error: str | None = None


class MicroBatcher:
    """Merges concurrent requests into flushes of ``scorer``. Thread-safe;
    ``workers=0`` scores inline on the caller's thread."""

    def __init__(self, scorer, *, max_batch: int = 64, window_ms: float = 0.0,
                 workers: int = 2):
        self.scorer = scorer
        self.max_batch = max(1, int(max_batch))
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self._cond = threading.Condition()
        self._queue: deque[_Request] = deque()
        self._rows = 0
        self._closed = False
        self.flushes = 0
        self.scored_requests = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"dct-torch-serve-{i}")
            for i in range(max(0, int(workers)))
        ]
        for t in self._threads:
            t.start()

    def score(self, x: np.ndarray, *, timeout: float = 60.0) -> np.ndarray:
        """Probabilities for one validated request; raises
        :class:`ScoringError` for a scoring failure, a non-finite result
        or a timeout."""
        req = _Request(np.ascontiguousarray(x, np.float32))
        if not self._threads:
            with self._cond:
                self.flushes += 1
            self._flush([req])
        else:
            with self._cond:
                if self._closed:
                    raise ScoringError("micro-batcher is closed")
                self._queue.append(req)
                self._rows += len(req.x)
                self._cond.notify()
            if not req.done.wait(timeout):
                raise ScoringError(f"scoring timed out after {timeout:.0f}s")
        if req.error is not None:
            raise ScoringError(req.error)
        return req.probs

    def _claim(self) -> list[_Request]:
        """Up to ``max_batch`` rows, at least one request; lock held."""
        take: list[_Request] = []
        rows = 0
        while self._queue and (
            not take or rows + len(self._queue[0].x) <= self.max_batch
        ):
            req = self._queue.popleft()
            take.append(req)
            rows += len(req.x)
        self._rows -= rows
        return take

    def _worker(self) -> None:
        while True:
            with self._cond:
                while True:
                    if not self._queue:
                        if self._closed:
                            return
                        self._cond.wait()
                        continue
                    deadline = self._queue[0].t + self.window_s
                    now = time.monotonic()
                    if (self._closed or self._rows >= self.max_batch
                            or now >= deadline):
                        batch = self._claim()
                        self.flushes += 1
                        break
                    self._cond.wait(deadline - now)
            self._flush(batch)

    def _flush(self, items: list[_Request]) -> None:
        try:
            stacked = (
                np.concatenate([r.x for r in items])
                if len(items) > 1 else items[0].x
            )
            probs = self.scorer(stacked)
            start = 0
            for req in items:
                p = probs[start:start + len(req.x)]
                start += len(req.x)
                if np.isfinite(p).all():
                    req.probs = p
                else:
                    req.error = "non-finite probabilities"
        except Exception as e:  # noqa: BLE001 - every failure past
            # validation is a server fault shared by the flush's requests.
            traceback.print_exc()
            for req in items:
                req.error = f"{type(e).__name__}: {e}"
        finally:
            with self._cond:
                self.scored_requests += len(items)
            for req in items:
                req.done.set()

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting requests, drain the queue, join the workers."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)
