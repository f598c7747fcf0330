"""Dynamic micro-batching and the serving engines (counterpart of
``dct_tpu/serving/batching.py``).

Handler threads validate and enqueue; scoring workers drain the queue,
merging compatible in-flight requests (same weights object, same family,
same row shape) into one flush of up to ``max_batch`` rows, waiting at
most ``window_ms`` past the oldest queued request for co-arrivals (0 =
whatever is queued when a worker frees up). A request always flushes
whole; one larger than ``max_batch`` flushes alone. The batch key holds
``id(weights)``, so a slot flip in endpoint mode never merges two
packages into one flush.

Two engines (``DCT_SERVE_ENGINE``):

- ``torch`` (the port's default): :class:`TorchScorer`, the port of the
  reference's jitted scorer (``_build_jax_scorer``): the registry model
  rebuilt from the package meta on one device, each flush padded to the
  next power of two by repeating its last row (an MoE request is scored
  at its true shape: its routing capacity depends on its token count,
  ``dct_tpu/serving/batching.py:217-223``), the causal family answered
  for the window's last position. A bf16 package runs at bf16 compute with
  its parameters resident in bf16 (its stored values are bf16-exact); an
  int8 package keeps its ``q8`` and per-channel scales resident as int8
  and f32 and dequantizes inside the forward (``q.float() * scale``, f32
  compute), as the reference's scorer does (a quantized kernel that is no
  dense layer's, the GRU's ``h_kernel``, is loaded dequantized). A
  request's answer may depend on its batch-mates in the last bits (as the
  reference's jax engine's).
- ``numpy``: :func:`score_rows_invariant`, the reference's default engine
  (the verbatim numpy runtime with the row-invariant matmul): a request's
  probabilities never depend on what it was batched with, and equal the
  reference's bit for bit.

The torch engine's scorers are cached per weights object, at most
:attr:`MicroBatcher._TORCH_SCORER_CAP`, each entry holding a strong
reference to its weights (an ``id`` is unique only while its object
lives).

The ``score`` fault point (``DCT_FAULT_SPEC``: ``crash_worker``,
``slow_score``) fires once per flush; ``DCT_SERVE_TRACE`` puts
``serve.batch_flush`` and ``serve.batch_error`` on the event log.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from dct_tpu_torch.serving.runtime import (
    QuantTensor,
    forward_numpy,
    rows_mm,
    softmax_numpy,
)


class ScoringError(RuntimeError):
    """A server-side scoring failure (HTTP 500: the request was valid)."""


def score_rows_invariant(weights: dict, meta: dict, arrays: list) -> list:
    """Score several validated requests as one flush; one ``[N_i, ...]``
    probability array per request, bit-identical to each request scored
    alone (``dct_tpu/serving/batching.py:56-79``)."""
    family = meta.get("model", "weather_mlp")
    if family == "weather_moe":
        # Routing capacity depends on the total token count: score each
        # request as its own segment.
        return [softmax_numpy(forward_numpy(weights, meta, a)) for a in arrays]
    stacked = np.concatenate(arrays, axis=0) if len(arrays) > 1 else arrays[0]
    probs = softmax_numpy(forward_numpy(weights, meta, stacked, mm=rows_mm))
    out, start = [], 0
    for a in arrays:
        out.append(probs[start:start + len(a)])
        start += len(a)
    return out


class Int8Dense(torch.nn.Module):
    """A dense layer of an int8 package: ``q8`` ``[out, in]`` int8 and
    ``scale`` ``[out]`` f32 resident, dequantized inside the forward at f32
    compute (the flax kernel ``[in, out]`` transposed; the bias f32)."""

    def __init__(self, q: np.ndarray, scale: np.ndarray, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("q8", torch.from_numpy(np.ascontiguousarray(
            np.asarray(q, np.int8).T)))
        self.register_buffer("scale", torch.from_numpy(
            np.asarray(scale, np.float32).copy()))
        self.bias = torch.nn.Parameter(bias.detach().float(),
                                       requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.q8.float() * self.scale[:, None]
        return torch.nn.functional.linear(x.float(), w, self.bias)


class TorchScorer:
    """Batched scorer for one package on one device: ``scorer(x)`` maps a
    validated ``[N, S, F]`` (or ``[N, F]``) f32 array to ``[N, C]``
    probabilities (``[N, horizon, C]`` for a multi-horizon causal
    package). ``forwards`` counts model forwards (one per call).

    An f32 package runs in full f32: on a CUDA device the scorer turns
    TF32 off for matmuls (``torch.backends.cuda.matmul.allow_tf32 =
    False``, process-wide). A bf16 scorer's matmuls are bf16, which that
    flag does not touch, so f32 and bf16 scorers in one process (endpoint
    mode) do not change each other's numbers."""

    def __init__(self, weights: dict, meta: dict, device):
        from dct_tpu_torch.convert import load_flax_weights
        from dct_tpu_torch.evaluation.harness import dense_weights, flax_keyed
        from dct_tpu_torch.models.registry import (
            config_from_meta,
            get_model,
            is_causal_model,
        )

        self.device = torch.device(device)
        qdtype = (meta.get("quant") or {}).get("dtype")
        if qdtype not in (None, "bf16", "int8"):
            raise ValueError(f"unknown package quant dtype {qdtype!r}")
        self.quant = qdtype
        self.dtype = torch.bfloat16 if qdtype == "bf16" else torch.float32
        if self.dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        cfg = config_from_meta(meta)
        family = meta.get("model", "weather_mlp")
        keyed = flax_keyed(weights, family)
        # Built on the host, then moved: an int8 layer's f32 weight never
        # reaches the card.
        model = get_model(cfg, device="cpu", dtype=self.dtype)
        load_flax_weights(model, dense_weights(keyed))
        for key, value in keyed.items():
            if isinstance(value, QuantTensor) and key.endswith("/kernel"):
                path = key.rsplit("/", 1)[0].split("/")
                parent = model
                for name in path[:-1]:
                    parent = getattr(parent, name)
                dense = getattr(parent, path[-1])
                setattr(parent, path[-1],
                        Int8Dense(value.q, value.scale, dense.bias))
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.causal = is_causal_model(cfg.name)
        # An MoE's capacity is a function of its token count: padding
        # rows would change which tokens are dropped.
        self.true_shape = getattr(model, "routing_depends_on_batch", False)
        self.forwards = 0
        # One forward at a time per scorer: concurrent flushes would only
        # interleave on the same card and multiply activation memory.
        self._lock = threading.Lock()

    def resident_bytes(self) -> int:
        """Bytes of the model's parameters and buffers on its device."""
        return sum(t.numel() * t.element_size() for t in
                   list(self.model.parameters()) + list(self.model.buffers()))

    def __call__(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        padded = 1
        while padded < n:
            padded *= 2
        if not self.true_shape and padded != n:
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

    def warm(self) -> float:
        """One forward on a zero window (loads the kernel libraries on the
        card, building them when missing); returns its seconds."""
        shape = ((1, self.model.seq_len, self.model.input_dim)
                 if hasattr(self.model, "seq_len")
                 else (1, self.model.input_dim))
        t0 = time.perf_counter()
        self(np.zeros(shape, np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0


def mesh_scorer(weights: dict, meta: dict, device, mesh,
                compute_dtype=None):
    """The batch engines' scorer (``predict_job``, the gate's accelerator
    engine), on one card or a world: the registry model built with
    ``mesh``'s attention engines, f32 parameters computing in
    ``compute_dtype`` (default f32; on a CUDA device TF32 off for
    matmuls, process-wide), the dense weights loaded (a quantized
    package's dequantized on the host), its tensor-parallel units split
    by the family rules
    (:func:`~dct_tpu_torch.parallel.sharding_rules.place_for_inference`)
    and its data block set (an MoE routes over the whole chunk), in eval
    mode. Returns ``rows -> probabilities`` (a tensor on ``device``;
    ``[N, C]``, or ``[N, H, C]`` for a multi-horizon causal model), to be
    driven by :func:`~dct_tpu_torch.parallel.mesh.score_split`."""
    from dct_tpu_torch.convert import load_flax_weights
    from dct_tpu_torch.evaluation.harness import dense_weights, flax_keyed
    from dct_tpu_torch.models.mlp import set_data_block
    from dct_tpu_torch.models.registry import (
        config_from_meta,
        get_model,
        is_causal_model,
    )
    from dct_tpu_torch.parallel.sharding_rules import place_for_inference

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    family = meta.get("model", "weather_mlp")
    model = get_model(config_from_meta(meta), device=dev,
                      dtype=torch.float32, compute_dtype=compute_dtype,
                      mesh=mesh)
    load_flax_weights(model, flax_keyed(dense_weights(weights), family))
    place_for_inference(model, mesh, family)
    set_data_block(model, mesh.data_size, mesh.data_index)
    model.eval().requires_grad_(False)
    causal = is_causal_model(family)

    def probs(piece: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            logits = model(torch.from_numpy(piece).to(dev))
        if causal:
            logits = logits[:, -1]
        return torch.softmax(logits.float(), dim=-1)

    return probs


class _Request:
    """One logical request in flight through the batcher."""

    __slots__ = ("x", "slot", "t", "done", "probs", "error")

    def __init__(self, x: np.ndarray, slot: str):
        self.x = x
        self.slot = slot
        self.t = time.monotonic()
        self.done = threading.Event()
        self.probs: np.ndarray | None = None
        self.error: str | None = None


class _Group:
    """Pending requests sharing one batch key (weights, family, row shape)."""

    __slots__ = ("weights", "meta", "items", "rows")

    def __init__(self, weights: dict, meta: dict):
        self.weights = weights
        self.meta = meta
        self.items: list[_Request] = []
        self.rows = 0

    @property
    def t_oldest(self) -> float:
        return self.items[0].t if self.items else float("inf")


def _emit(event: str, **fields) -> None:
    from dct_tpu_torch.observability import events as _events

    _events.get_default().emit("serve", event, **fields)


class MicroBatcher:
    """The dynamic micro-batcher behind both HTTP server modes.

    - ``max_batch`` caps a flush in rows (a request always flushes whole);
    - ``window_ms`` is the co-arrival deadline past the oldest queued
      request (0 = opportunistic);
    - ``workers`` scoring threads drain the queue; ``workers=0`` scores
      inline on the caller's thread through the same dispatch;
    - ``engine`` is ``torch`` (on ``device``) or ``numpy``.

    Thread-safe; shared by every handler thread of a server."""

    #: Torch scorers kept per batcher: each pins its weights on the card.
    _TORCH_SCORER_CAP = 8

    #: Flush completions older than this stop informing the service rate.
    _RATE_WINDOW_S = 10.0

    def __init__(self, *, max_batch: int = 64, window_ms: float = 0.0,
                 workers: int = 2, engine: str = "torch", device=None,
                 metrics=None, emit_events: bool | None = None):
        from dct_tpu_torch.config import _env, check_engine

        self.max_batch = max(1, int(max_batch))
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.engine = check_engine(engine)
        self.device = device
        self.metrics = metrics
        if emit_events is None:
            emit_events = _env("DCT_SERVE_TRACE", False, bool)
        self.emit_events = bool(emit_events)
        self._cond = threading.Condition()
        self._groups: dict = {}
        self._order: deque = deque()
        self._closed = False
        self._scorers: dict = {}
        self._scorer_lock = threading.Lock()
        self.flushes = 0
        self.scored_requests = 0
        self._shrink = 0
        self._spawned = 0
        # (t_done, rows) of recent flushes: the admission controller's
        # service-rate window.
        self._done: deque = deque(maxlen=256)
        self._threads: list[threading.Thread] = []
        for _ in range(max(0, int(workers))):
            self._spawn_worker()

    # -- request side ---------------------------------------------------

    def score(self, weights: dict, meta: dict, x: np.ndarray, *,
              slot: str = "default", timeout: float = 60.0) -> np.ndarray:
        """Probabilities for one validated request; raises
        :class:`ScoringError` for a scoring failure, a non-finite result
        or a timeout."""
        if not self._threads:
            return self._score_one(weights, meta, x)
        req = _Request(np.ascontiguousarray(x, np.float32), slot)
        key = (id(weights), meta.get("model", "weather_mlp"), x.shape[1:])
        with self._cond:
            if self._closed:
                raise ScoringError("micro-batcher is closed")
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _Group(weights, meta)
                self._order.append(key)
            g.items.append(req)
            g.rows += len(req.x)
            self._cond.notify()
        if not req.done.wait(timeout):
            raise ScoringError(f"scoring timed out after {timeout:.0f}s")
        if req.error is not None:
            raise ScoringError(req.error)
        return req.probs

    def _score_one(self, weights: dict, meta: dict, x: np.ndarray):
        with self._cond:
            if self._closed:
                raise ScoringError("micro-batcher is closed")
            self.flushes += 1
            self.scored_requests += 1
            seq = self.scored_requests
        self._fire_score_faults(seq)
        try:
            probs = self._dispatch(weights, meta,
                                   [np.ascontiguousarray(x, np.float32)])[0]
        except Exception as e:  # noqa: BLE001 - past validation: ours
            raise ScoringError(f"{type(e).__name__}: {e}") from e
        if not np.isfinite(probs).all():
            raise ScoringError("non-finite probabilities")
        return probs

    # -- saturation introspection (admission control, autoscaling) ------

    def queued_rows(self) -> int:
        """Rows queued behind in-flight flushes."""
        with self._cond:
            return sum(g.rows for g in self._groups.values())

    def service_rate(self) -> float | None:
        """Recent rows/second over all workers (None until two flushes
        completed inside the window)."""
        now = time.monotonic()
        with self._cond:
            while self._done and now - self._done[0][0] > self._RATE_WINDOW_S:
                self._done.popleft()
            if len(self._done) < 2:
                return None
            rows = sum(r for _, r in self._done)
            span = now - self._done[0][0]
        return rows / span if span > 0 else None

    def saturation(self) -> tuple:
        """``(queued_rows, est_wait_s or None)`` in one lock pass."""
        now = time.monotonic()
        with self._cond:
            queued = sum(g.rows for g in self._groups.values())
            while self._done and now - self._done[0][0] > self._RATE_WINDOW_S:
                self._done.popleft()
            if len(self._done) < 2:
                return queued, None
            rows = sum(r for _, r in self._done)
            span = now - self._done[0][0]
        if span <= 0 or rows <= 0:
            return queued, None
        return queued, queued / (rows / span)

    def _fire_score_faults(self, seq: int) -> None:
        """The ``score`` fault point: ``crash_worker`` exits this process,
        ``slow_score`` sleeps in every flush."""
        from dct_tpu_torch.resilience import faults as _faults

        plan = _faults.get_default()
        if plan.enabled:
            plan.maybe_fire("score", req=seq)

    # -- engines --------------------------------------------------------

    def scorer_for(self, weights: dict, meta: dict) -> TorchScorer:
        """The torch scorer of ``weights`` (built on first use; at most
        :attr:`_TORCH_SCORER_CAP` kept, oldest evicted)."""
        key = id(weights)
        with self._scorer_lock:
            entry = self._scorers.get(key)
            if entry is not None and entry[0] is weights:
                return entry[1]
        from dct_tpu_torch.device import resolve_device

        scorer = TorchScorer(weights, meta, resolve_device(self.device))
        with self._scorer_lock:
            entry = self._scorers.get(key)
            if entry is not None and entry[0] is weights:
                return entry[1]  # a concurrent first flush won the race
            self._scorers[key] = (weights, scorer)
            while len(self._scorers) > self._TORCH_SCORER_CAP:
                self._scorers.pop(next(iter(self._scorers)))
        return scorer

    def _dispatch(self, weights: dict, meta: dict, arrays: list) -> list:
        if self.engine == "numpy":
            return score_rows_invariant(weights, meta, arrays)
        fn = self.scorer_for(weights, meta)
        if fn.true_shape:
            return [fn(a) for a in arrays]
        stacked = np.concatenate(arrays, axis=0) if len(arrays) > 1 else arrays[0]
        probs = fn(stacked)
        out, start = [], 0
        for a in arrays:
            out.append(probs[start:start + len(a)])
            start += len(a)
        return out

    # -- worker side ----------------------------------------------------

    def _claim(self, key, g: _Group) -> tuple:
        """Pop up to ``max_batch`` rows of ``g`` (at least one request);
        the caller holds the lock."""
        take: list[_Request] = []
        rows = 0
        while g.items and (
            not take or rows + len(g.items[0].x) <= self.max_batch
        ):
            req = g.items.pop(0)
            take.append(req)
            rows += len(req.x)
        g.rows -= rows
        if not g.items:
            self._groups.pop(key, None)
            try:
                self._order.remove(key)
            except ValueError:
                pass
        return g.weights, g.meta, take

    def _spawn_worker(self) -> None:
        t = threading.Thread(target=self._worker, daemon=True,
                             name=f"dct-torch-serve-{self._spawned}")
        self._spawned += 1
        self._threads.append(t)
        t.start()

    @property
    def workers(self) -> int:
        """Target worker count (live threads minus pending shrinks)."""
        with self._cond:
            return max(0, len(self._threads) - self._shrink)

    def set_workers(self, n: int) -> None:
        """Scale the scoring threads to ``n``: the autoscaler's in-process
        axis. Surplus workers leave between flushes, never mid-flush."""
        n = max(0, int(n))
        with self._cond:
            if self._closed:
                return
            current = len(self._threads) - self._shrink
            if n < current:
                self._shrink += current - n
                self._cond.notify_all()
                return
            spawn = n - current
        for _ in range(max(0, spawn)):
            with self._cond:
                if self._shrink > 0:  # an unserved shrink cancels out
                    self._shrink -= 1
                    continue
            self._spawn_worker()

    def _worker(self) -> None:
        while True:
            batch = None
            with self._cond:
                while batch is None:
                    if self._shrink > 0:
                        self._shrink -= 1
                        try:
                            self._threads.remove(threading.current_thread())
                        except ValueError:
                            pass
                        return
                    if self._closed and not self._groups:
                        return
                    now = time.monotonic()
                    next_deadline = None
                    for key in list(self._order):
                        g = self._groups.get(key)
                        if g is None or not g.items:
                            self._groups.pop(key, None)
                            try:
                                self._order.remove(key)
                            except ValueError:
                                pass
                            continue
                        deadline = g.t_oldest + self.window_s
                        if (self._closed or g.rows >= self.max_batch
                                or now >= deadline):
                            batch = self._claim(key, g)
                            break
                        if next_deadline is None or deadline < next_deadline:
                            next_deadline = deadline
                    if batch is None:
                        if self._closed and not self._groups:
                            return
                        if next_deadline is None:
                            self._cond.wait()
                        else:
                            self._cond.wait(max(0.0, next_deadline - now))
                queue_depth = sum(grp.rows for grp in self._groups.values())
                self.flushes += 1
            self._flush(batch, queue_depth)

    def _flush(self, batch: tuple, queue_depth: int) -> None:
        weights, meta, items = batch
        rows = sum(len(req.x) for req in items)
        waited_ms = round((time.monotonic() - min(r.t for r in items)) * 1e3,
                          3)
        with self._cond:
            self.scored_requests += len(items)
            seq = self.scored_requests
        self._fire_score_faults(seq)
        try:
            results = self._dispatch(weights, meta, [r.x for r in items])
            for req, probs in zip(items, results):
                if np.isfinite(probs).all():
                    req.probs = probs
                else:
                    req.error = "non-finite probabilities"
        except Exception as e:  # noqa: BLE001 - past validation, any
            # failure is a server fault shared by the flush's requests.
            msg = f"{type(e).__name__}: {e}"
            for req in items:
                req.error = msg
            if self.emit_events:
                _emit("serve.batch_error", rows=rows, requests=len(items),
                      error=msg[:300])
        finally:
            for req in items:
                req.done.set()
            with self._cond:
                # After any slow_score sleep: the rate prices real capacity.
                self._done.append((time.monotonic(), rows))
        if self.metrics is not None:
            try:
                self.metrics.observe_batch(rows, len(items), queue_depth)
            except Exception:  # noqa: BLE001 - telemetry never fails a flush
                pass
        if self.emit_events:
            _emit("serve.batch_flush", rows=rows, requests=len(items),
                  queue_depth=queue_depth, waited_ms=waited_ms)

    # -- lifecycle ------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting requests, drain pending flushes, join workers."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for t in list(self._threads):
            t.join(timeout)


def batcher_from_env(metrics=None, device=None) -> MicroBatcher:
    """A :class:`MicroBatcher` from the ``DCT_SERVE_*`` knobs."""
    from dct_tpu_torch.config import ServingConfig

    cfg = ServingConfig.from_env()
    return MicroBatcher(max_batch=cfg.max_batch,
                        window_ms=cfg.batch_window_ms, workers=cfg.workers,
                        engine=cfg.engine, device=device, metrics=metrics)
