"""MPMD pipeline parallelism (counterpart of ``dct_tpu/parallel/mpmd.py``):
each stage of ``weather_transformer_pp`` is a program of its own on a card
of its own, with explicit activation and gradient transfers between
neighbours and a 1F1B (PipeDream-flush) or GPipe schedule per stage.

- :func:`parse_stage_spec` / :func:`spec_from_env_values`: the
  ``DCT_MPMD_*`` grammar, with the reference's messages;
- :func:`carve_stage_meshes`: a carve of **cards** — stage ``k`` takes card
  ``sum(counts[:k])``. ``device`` (``DCT_DEVICE``) names one device, and
  then every stage lies on it (so one card runs ``1,1``). A stage slice
  of more than one card, or a model axis inside a stage, raises naming
  ROADMAP item 17c;
- :func:`build_schedule`, :func:`analytic_bubble`,
  :func:`measured_bubble`: copies;
- :func:`split_state` / :func:`merge_stage_states`: the full
  :class:`~dct_tpu_torch.train.state.TrainState` of the pipeline family
  <-> one :class:`StageModel` state per stage. Stage ``k`` owns its row of
  ``pp_stages`` (a :class:`~dct_tpu_torch.models.transformer.StageStack`
  holding that stage alone); stage 0 also ``in_proj``, the last stage
  ``ln_out`` and ``head``. Every per-parameter optimizer list (Adam's
  ``mu``/``nu``, Lion's ``mu``, the momentum trace) splits and merges the
  same way. Both directions copy values, bitwise;
- :func:`make_stage_programs`: ``fwd`` runs under ``no_grad``; ``bwd``
  recomputes the stage forward from the saved stage input under
  ``enable_grad`` and back-propagates the incoming gradient (the
  reference's stage backward is one ``jax.vjp`` program, so the only
  residual kept between ops is the stage input, the 1F1B in-flight set);
  gradients accumulate per microbatch as ``acc + gp`` and the update
  divides by the step's total weight;
- :class:`StageExecutor` runs one stage's op list against its neighbour
  channels, ending every program with a synchronize of the stage's device
  (the reference's ``block_until_ready``), so ``busy_s``,
  ``transfer_wait_s`` and the per-phase seconds are device time; it counts
  the stage's flash launches (:func:`dct_tpu_torch.ops.flash_attention.
  counted_launches`). :class:`MpmdRunner` runs one thread per stage, each
  on its card; a payload moves to the consumer's card with ``.to()``.
"""

from __future__ import annotations

import copy
import dataclasses
import queue
import threading
import time

import numpy as np
import torch
from torch import nn

SCHEDULES = ("1f1b", "gpipe")
ITEM_17C = ("stage slices of several cards are ROADMAP item 17c (a "
            "stage's processes as one group, with its rule placement)")


class MpmdSpecError(ValueError):
    """A malformed MPMD spec (stage map / schedule / microbatches) —
    raised at parse time, naming the offending clause: a typo'd
    pipeline must never silently train single-stage."""


class MpmdTransferTimeout(RuntimeError):
    """An inter-stage transfer did not arrive within the configured
    ``DCT_MPMD_TRANSFER_TIMEOUT_S`` window — a dead or wedged neighbor
    stage."""


@dataclasses.dataclass
class MpmdSpec:
    """The resolved MPMD run shape (config.MpmdConfig, parsed)."""

    n_stages: int
    device_counts: tuple  # per-stage device counts, len == n_stages
    n_microbatches: int
    schedule: str = "1f1b"
    transfer_timeout_s: float = 120.0
    port_base: int = 29600

    @property
    def total_devices(self) -> int:
        return int(sum(self.device_counts))


def parse_stage_spec(text: str, *, n_devices: int | None = None) -> tuple:
    """``DCT_MPMD_STAGES`` -> per-stage device counts: ``"P"`` (P stages,
    the ``n_devices`` pool split evenly when given) or ``"d0,d1,..."``.
    Raises :class:`MpmdSpecError` naming the clause on an empty spec, a
    non-integer token, a count below 1, fewer than 2 stages, or more
    devices than ``n_devices``."""
    raw = (text or "").strip()
    if not raw:
        raise MpmdSpecError(
            "DCT_MPMD_STAGES is empty: expected a stage count ('2') or "
            "per-stage device counts ('1,1')"
        )
    toks = [t.strip() for t in raw.split(",")]
    for t in toks:
        if not (t.lstrip("-").isdigit()):
            raise MpmdSpecError(
                f"DCT_MPMD_STAGES token {t!r} is not an integer "
                f"(spec: {raw!r})"
            )
    vals = [int(t) for t in toks]
    if len(vals) == 1:
        p = vals[0]
        if p < 2:
            raise MpmdSpecError(
                f"DCT_MPMD_STAGES={p}: an MPMD pipeline needs >= 2 "
                "stages (use the plain trainer for 1)"
            )
        if n_devices is not None:
            if n_devices % p:
                raise MpmdSpecError(
                    f"DCT_MPMD_STAGES={p} does not divide the "
                    f"{n_devices}-device pool evenly; give explicit "
                    "per-stage counts instead"
                )
            return tuple([n_devices // p] * p)
        return tuple([1] * p)
    if any(v < 1 for v in vals):
        raise MpmdSpecError(
            f"DCT_MPMD_STAGES={raw!r}: every per-stage device count "
            "must be >= 1"
        )
    if len(vals) < 2:
        raise MpmdSpecError(
            f"DCT_MPMD_STAGES={raw!r}: an MPMD pipeline needs >= 2 stages"
        )
    if n_devices is not None and sum(vals) > n_devices:
        raise MpmdSpecError(
            f"DCT_MPMD_STAGES={raw!r} asks for {sum(vals)} devices but "
            f"only {n_devices} are available"
        )
    return tuple(vals)


def spec_from_env_values(
    stages: str, microbatches: int, schedule: str,
    transfer_timeout_s: float, port_base: int,
    *, n_devices: int | None = None,
) -> MpmdSpec:
    """Validate the raw MpmdConfig knob values into an :class:`MpmdSpec`
    (all failures are loud :class:`MpmdSpecError`, at parse time)."""
    counts = parse_stage_spec(stages, n_devices=n_devices)
    sched = (schedule or "1f1b").strip().lower()
    if sched not in SCHEDULES:
        raise MpmdSpecError(
            f"DCT_MPMD_SCHEDULE={schedule!r} not in {SCHEDULES}"
        )
    m = int(microbatches) if microbatches else 2 * len(counts)
    if m < len(counts):
        raise MpmdSpecError(
            f"DCT_MPMD_MICROBATCHES={m} < {len(counts)} stages: the "
            "pipeline would never reach steady state"
        )
    if transfer_timeout_s <= 0:
        raise MpmdSpecError(
            f"DCT_MPMD_TRANSFER_TIMEOUT_S={transfer_timeout_s} must be "
            "> 0 (a zero timeout is an instant transfer failure)"
        )
    return MpmdSpec(
        n_stages=len(counts), device_counts=counts, n_microbatches=m,
        schedule=sched, transfer_timeout_s=float(transfer_timeout_s),
        port_base=int(port_base),
    )


def check_stage_slices(counts, *, model: int = 1) -> None:
    """Raise unless every stage is one card with no model axis (ROADMAP
    item 17c)."""
    wide = [k for k, c in enumerate(counts) if int(c) != 1]
    if wide:
        raise MpmdSpecError(
            f"stage(s) {wide} of the stage map {tuple(counts)} take more "
            f"than one card; the port runs one card a stage: {ITEM_17C}"
        )
    if model > 1:
        raise MpmdSpecError(
            f"DCT_MESH_MODEL={model} inside an MPMD stage: the port runs "
            f"one card a stage: {ITEM_17C}"
        )


def carve_stage_meshes(counts, devices=None, *, model: int = 1,
                       device=None) -> list[torch.device]:
    """Stage ``k``'s card: ``devices[sum(counts[:k])]`` (default: every
    CUDA device). ``device`` (the ``DCT_DEVICE`` override) puts every
    stage on that one device. Raises naming item 17c for a stage slice of
    more than one card or a model axis, and the reference's refusal when
    the pool is too small."""
    from dct_tpu_torch.device import resolve_device

    check_stage_slices(counts, model=model)
    if device is not None:
        dev = resolve_device(device)
        return [dev] * len(counts)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if sum(counts) > len(devices):
        raise MpmdSpecError(
            f"stage device counts {tuple(counts)} need {sum(counts)} "
            f"devices, have {len(devices)}"
        )
    out, off = [], 0
    for c in counts:
        out.append(resolve_device(devices[off]))
        off += c
    return out


def slice_descriptor(counts) -> str:
    """One label value for a stage map's slice topology."""
    return "x".join(str(int(c)) for c in counts)


# ----------------------------------------------------------------------
# Schedules. Ops are (kind, microbatch, phase); per-stage lists execute
# strictly in order, blocking on the neighbor channels for inputs.


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str  # "fwd" | "bwd"
    mb: int
    phase: str  # "fill" | "steady" | "drain"


def build_schedule(n_stages: int, n_microbatches: int, kind: str = "1f1b"):
    """Per-stage op lists. ``1f1b``: stage ``i`` warms up with
    ``min(P-1-i, M)`` forwards (``fill``), alternates fwd/bwd
    (``steady``), drains the remaining backwards (``drain``). ``gpipe``:
    all M forwards then all M backwards; the first ``P-1-i`` forwards are
    the fill, the trailing backwards past the last aligned one the
    drain."""
    p, m = int(n_stages), int(n_microbatches)
    if kind not in SCHEDULES:
        raise MpmdSpecError(f"unknown schedule {kind!r} (valid: {SCHEDULES})")
    out = []
    for i in range(p):
        ops: list[Op] = []
        if kind == "1f1b":
            warm = min(p - 1 - i, m)
            for j in range(warm):
                ops.append(Op("fwd", j, "fill"))
            for j in range(m - warm):
                ops.append(Op("fwd", warm + j, "steady"))
                ops.append(Op("bwd", j, "steady"))
            for j in range(m - warm, m):
                ops.append(Op("bwd", j, "drain"))
        else:  # gpipe
            warm = min(p - 1 - i, m)
            for j in range(m):
                ops.append(Op("fwd", j, "fill" if j < warm else "steady"))
            drain_from = m - warm
            for j in range(m):
                ops.append(
                    Op("bwd", j, "steady" if j < drain_from else "drain")
                )
        out.append(ops)
    return out


def analytic_bubble(n_stages: int, n_microbatches: int) -> float:
    """The uniform-tick bubble fraction ``(P-1)/(M+P-1)`` both schedules
    obey over the whole step."""
    p, m = int(n_stages), int(n_microbatches)
    return (p - 1) / float(m + p - 1)


def measured_bubble(t_small: float, t_large: float,
                    m_small: int, m_large: int) -> float:
    """Slope-method measured bubble at ``m_small`` microbatches: fit
    ``t(M) = a*M + c`` through two step walls; the bubble is
    ``1 - a*M/t(M)``."""
    if m_large <= m_small or t_small <= 0:
        raise ValueError("need m_large > m_small and t_small > 0")
    slope = (t_large - t_small) / float(m_large - m_small)
    return max(0.0, min(1.0, 1.0 - slope * m_small / t_small))


# ----------------------------------------------------------------------
# TrainState pivot: the full pipeline-family state <-> per-stage states.

STACKED_KEY = "pp_stages"
STAGE_KEY = "stage"
_FIRST_EXTRAS = ("in_proj",)
_LAST_EXTRAS = ("ln_out", "head")


def stage_layers(n_layers: int, n_stages: int) -> int:
    """Layers per stage, or a loud refusal when the model cannot tile
    the requested stage map (the untileable-stage contract)."""
    if n_stages < 2:
        raise MpmdSpecError(f"n_stages={n_stages}: MPMD needs >= 2 stages")
    if n_layers % n_stages:
        raise MpmdSpecError(
            f"n_layers={n_layers} does not tile n_stages={n_stages} "
            "homogeneous stages; adjust DCT_N_LAYERS or DCT_MPMD_STAGES"
        )
    return n_layers // n_stages


class StageModel(nn.Module):
    """Stage ``k`` of a ``WeatherTransformerPP``: its row of
    ``pp_stages`` as ``stage`` (a one-stage ``StageStack``); stage 0 also
    ``in_proj`` and the sinusoidal table, the last stage ``ln_out`` and
    ``head``; every stage the rope tables under ``pos_embed="rope"``. Its
    flax paths (``stage/block_<i>/...``, ``in_proj/...``) are the
    reference's stage tree, with the stage dim kept (``[1, ...]``)."""

    def __init__(self, full: nn.Module, k: int, n_stages: int):
        super().__init__()
        self.k, self.n_stages = int(k), int(n_stages)
        self.compute_dtype = full.compute_dtype
        self.seq_parallel = None
        self.pos_embed, self.input_dim = full.pos_embed, full.input_dim
        first, last = self.k == 0, self.k == self.n_stages - 1
        if first:
            self.in_proj = copy.deepcopy(full.in_proj)
        stage = copy.deepcopy(full.pp_stages)
        stage.keep_stage(self.k)
        self.stage = stage
        if last:
            self.ln_out = copy.deepcopy(full.ln_out)
            self.head = copy.deepcopy(full.head)
        for name in ("rope_cos", "rope_sin") if self.pos_embed == "rope" \
                else (("pos_table",) if first else ()):
            self.register_buffer(name, getattr(full, name), persistent=False)

    def rope(self, t: int):
        if self.pos_embed != "rope":
            return None
        return self.rope_cos[:t], self.rope_sin[:t]


def _pp_stages(model: nn.Module) -> nn.Module:
    stacked = getattr(model, STACKED_KEY, None)
    if stacked is None:
        raise MpmdSpecError(
            f"param tree has no '{STACKED_KEY}' stacked stage pytree — "
            "MPMD requires the pipeline-parallel family "
            "(weather_transformer_pp)"
        )
    return stacked


def split_params(model: nn.Module, k: int, n_stages: int,
                 device=None) -> StageModel:
    """Stage ``k``'s :class:`StageModel` of the full pipeline-family
    ``model`` (copies of its values, bitwise), on ``device`` (default:
    the model's)."""
    lead = int(_pp_stages(model).n_stages)
    if lead != n_stages:
        raise MpmdSpecError(
            f"checkpoint holds {lead} stacked stages but the run "
            f"configures {n_stages} — an untileable stage map; restore "
            "with the saving stage count or retrain"
        )
    stage = StageModel(model, k, n_stages)
    if device is not None:
        stage.to(device)
    return stage


def _stage_index(full: nn.Module, stage: StageModel) -> list[tuple]:
    """For each parameter of ``stage`` (its order): (the full model's
    parameter index, whether it is a row of the stacked stages)."""
    index = {name: i for i, (name, _) in enumerate(full.named_parameters())}
    out = []
    for name, _ in stage.named_parameters():
        if name.startswith(STAGE_KEY + "."):
            out.append((index[f"{STACKED_KEY}.{name[len(STAGE_KEY) + 1:]}"],
                        True))
        else:
            out.append((index[name], False))
    return out


def merge_params(stage_models: list, into: nn.Module) -> nn.Module:
    """Write the per-stage models' values into the full model ``into``
    (the inverse of :func:`split_params`, bitwise) and return it."""
    n = len(stage_models)
    lead = int(_pp_stages(into).n_stages)
    if lead != n:
        raise MpmdSpecError(
            f"{n} stage states do not tile the template's {lead} stacked "
            "stages — an untileable stage map"
        )
    params = list(into.parameters())
    with torch.no_grad():
        for k, sm in enumerate(stage_models):
            for (i, stacked), p in zip(_stage_index(into, sm),
                                       sm.parameters()):
                dst = params[i][k:k + 1] if stacked else params[i]
                dst.copy_(p.detach().to(params[i].device))
    return into


def _map_opt_mirrors(tx, st, fn):
    """``st`` rebuilt with ``fn`` applied to every per-parameter list
    (the moments of each transformation of ``tx``)."""
    if tx.kind == "chain":
        return [_map_opt_mirrors(t, s, fn) for t, s in zip(tx.parts, st)]
    if tx.kind == "adam":
        return {"count": st["count"], "mu": fn(st["mu"]), "nu": fn(st["nu"])}
    if tx.kind == "lion":
        return {"count": st["count"], "mu": fn(st["mu"])}
    if tx.kind == "trace":
        return fn(st)
    return st


def _zip_opt_mirrors(tx, states: list, fn):
    """Walk the stages' structurally parallel optimizer states; at every
    per-parameter list call ``fn([list_0, ..., list_P-1])``; other nodes
    come from stage 0."""
    if tx.kind == "chain":
        return [_zip_opt_mirrors(t, [s[j] for s in states], fn)
                for j, t in enumerate(tx.parts)]
    if tx.kind == "adam":
        return {"count": states[0]["count"],
                "mu": fn([s["mu"] for s in states]),
                "nu": fn([s["nu"] for s in states])}
    if tx.kind == "lion":
        return {"count": states[0]["count"],
                "mu": fn([s["mu"] for s in states])}
    if tx.kind == "trace":
        return fn(list(states))
    return states[0]


def _tx_kinds(tx) -> tuple:
    return (tx.kind, tuple(_tx_kinds(t) for t in tx.parts))


def split_state(full_state, k: int, n_stages: int, device=None):
    """The full pipeline-family TrainState -> stage ``k``'s (the same
    optimizer, step, seed and dropout seed; each moment list split as the
    parameters are). Bitwise: every value is a copy of a row or a leaf."""
    from dct_tpu_torch.train.state import TrainState

    if full_state.layout is not None and full_state.layout.sharded:
        raise MpmdSpecError(
            "split_state takes an unplaced state (every leaf whole); this "
            "one is split over a mesh"
        )
    model = split_params(full_state.model, k, n_stages, device)
    dev = next(model.parameters()).device
    idx = _stage_index(full_state.model, model)

    def take(values):
        return [(values[i][k:k + 1] if stacked else values[i])
                .detach().to(dev, copy=True) for i, stacked in idx]

    return TrainState(
        model=model, tx=full_state.tx,
        opt_state=_map_opt_mirrors(full_state.tx, full_state.opt_state, take),
        step=full_state.step, seed=full_state.seed, rng=full_state.rng)


def merge_stage_states(stage_states: list, template):
    """Per-stage TrainStates -> ``template`` (a full pipeline-family
    TrainState, unplaced), written in place and returned: the inverse
    pivot, bitwise. Raises when the stages' optimizers differ."""
    kinds = {_tx_kinds(s.tx) for s in stage_states}
    if len(kinds) != 1 or _tx_kinds(template.tx) not in kinds:
        raise MpmdSpecError(
            "stage optimizer states do not mirror their params — mixed "
            "optimizer configs across stages"
        )
    merge_params([s.model for s in stage_states], template.model)
    full_params = template.params
    dev = full_params[0].device
    maps = [_stage_index(template.model, s.model) for s in stage_states]

    def merge(lists):
        out = [None] * len(full_params)
        for k, (values, idx) in enumerate(zip(lists, maps)):
            if len(values) != len(idx):
                raise MpmdSpecError(
                    f"stage {k}'s optimizer state does not mirror its "
                    "params — mixed optimizer configs across stages")
            for (i, stacked), v in zip(idx, values):
                v = v.detach().to(dev)
                if stacked:
                    if out[i] is None:
                        out[i] = torch.empty_like(full_params[i])
                    out[i][k:k + 1].copy_(v)
                else:
                    out[i] = v.clone()
        return out

    template.opt_state = _zip_opt_mirrors(
        template.tx, [s.opt_state for s in stage_states], merge)
    template.step = stage_states[0].step
    template.rng = stage_states[0].rng
    return template


# ----------------------------------------------------------------------
# Per-stage programs: fwd / bwd / update (and the last stage's eval). The
# backward recomputes the stage forward from the stored stage input.


def make_stage_programs(k: int, n_stages: int, stage_fns: dict) -> dict:
    """Stage ``k``'s programs from the model-level callables
    (``first_fwd(m, x)``, ``mid_fwd(m, a)``, ``last_fwd(m, a, y, w) ->
    (loss_sum, count)``, ``last_eval``, each taking the stage's
    :class:`StageModel`): ``{"fwd", "bwd", "update"[, "eval"]}``."""
    first, last = k == 0, k == n_stages - 1
    if first:
        fwd_fn = stage_fns["first_fwd"]
    elif last:
        fwd_fn = stage_fns["last_fwd"]
    else:
        fwd_fn = stage_fns["mid_fwd"]

    def fwd(model, *args):
        with torch.no_grad():
            return fwd_fn(model, *args)

    def _grads(model, outputs, cotangent, a_in):
        params = list(model.parameters())
        leaves = params + ([a_in] if a_in is not None else [])
        gs = torch.autograd.grad(outputs, leaves, cotangent)
        return list(gs[:len(params)]), (gs[-1] if a_in is not None else None)

    if last:
        def bwd(model, a_in, y, w, acc):
            with torch.enable_grad():
                a = a_in.detach().requires_grad_(True)
                loss_sum = stage_fns["last_fwd"](model, a, y, w)[0]
                gp, ga = _grads(model, loss_sum, None, a)
            return torch._foreach_add(acc, gp), ga
    elif first:
        def bwd(model, x, g, acc):
            with torch.enable_grad():
                out = fwd_fn(model, x)
                gp, _ = _grads(model, out, g, None)
            return torch._foreach_add(acc, gp)
    else:
        def bwd(model, a_in, g, acc):
            with torch.enable_grad():
                a = a_in.detach().requires_grad_(True)
                out = fwd_fn(model, a)
                gp, ga = _grads(model, out, g, a)
            return torch._foreach_add(acc, gp), ga

    def update(state, acc, total):
        grads = torch._foreach_div(acc, float(total))
        return state.apply_gradients(grads, None)

    progs = {"fwd": fwd, "bwd": bwd, "update": update}
    if last:
        def evaluate(model, a, y, w):
            with torch.no_grad():
                return stage_fns["last_eval"](model, a, y, w)

        progs["eval"] = evaluate
    return progs


def zero_grads(params) -> list[torch.Tensor]:
    return [torch.zeros_like(p) for p in params]


# ----------------------------------------------------------------------
# Stage execution: one stage's op list against neighbor channels. The
# channel protocol is two methods — ``send(payload)`` and
# ``recv(timeout) -> payload`` — implemented in-process by
# :class:`QueueChannel` and cross-process by
# :class:`dct_tpu_torch.parallel.mpmd_transfer.SocketChannel`.


class QueueChannel:
    """In-process channel: a queue of tensors (the move to the
    consumer's card happens on the SENDER, so the consumer's wait is
    genuine transfer wait)."""

    def __init__(self, maxsize: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)

    def send(self, payload) -> None:
        self._q.put(payload)

    def recv(self, timeout: float):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise MpmdTransferTimeout(
                f"no payload within {timeout}s"
            ) from None


@dataclasses.dataclass
class StageReport:
    """One stage's accounting for one pipeline step (``launches``: its
    flash launches by kernel)."""

    stage: int
    busy_s: float = 0.0
    transfer_wait_s: float = 0.0
    send_s: float = 0.0
    phase_busy: dict = dataclasses.field(
        default_factory=lambda: {"fill": 0.0, "steady": 0.0, "drain": 0.0}
    )
    steady_window_s: float = 0.0
    steady_busy_s: float = 0.0
    window_s: float = 0.0
    launches: dict = dataclasses.field(default_factory=dict)


def device_sync(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageExecutor:
    """Executes ONE stage's schedule for one optimizer step.

    ``channels``: dict with (any of) ``act_in``/``act_out``/``grad_in``/
    ``grad_out``; ``place_in`` maps an incoming payload onto this stage's
    device (host numpy for the socket plane). Every program ends in a
    synchronize of ``device``, so the per-phase busy/wait attribution is
    device time, not dispatch time."""

    def __init__(
        self, k: int, n_stages: int, programs: dict, *,
        channels: dict, transfer_timeout_s: float = 120.0,
        place_in=None, clock=time.perf_counter, device="cpu",
    ):
        self.k = k
        self.n_stages = n_stages
        self.programs = programs
        self.channels = channels
        self.timeout = transfer_timeout_s
        self.place_in = place_in or (lambda x: x)
        self.clock = clock
        self.device = torch.device(device)

    def _sync(self) -> None:
        device_sync(self.device)

    def _recv(self, name: str, rep: StageReport):
        t0 = self.clock()
        try:
            payload = self.channels[name].recv(self.timeout)
        except MpmdTransferTimeout as e:
            raise MpmdTransferTimeout(
                f"stage {self.k} waited > {self.timeout}s on {name} "
                f"({e})"
            ) from e
        rep.transfer_wait_s += self.clock() - t0
        return self.place_in(payload)

    def _send(self, name: str, payload, rep: StageReport) -> None:
        ch = self.channels.get(name)
        if ch is None:
            return
        t0 = self.clock()
        ch.send(payload)
        rep.send_s += self.clock() - t0

    def run_step(self, ops, state, microbatches, total) -> tuple:
        """Run one optimizer step's op list. ``microbatches``: for stage
        0 a list of x microbatches; for the last stage a list of (y, w)
        pairs; None for middle stages. Returns (new_state, report,
        loss_sums), loss_sums populated on the last stage only."""
        from dct_tpu_torch.ops.flash_attention import counted_launches

        k, p = self.k, self.n_stages
        first, last = k == 0, k == p - 1
        rep = StageReport(stage=k)
        model = state.model
        saved: dict[int, object] = {}
        loss_sums: list = []
        t_start = None
        steady_t0 = steady_t1 = None
        with counted_launches() as counts:
            acc = zero_grads(state.params)
            for op in ops:
                if op.kind == "fwd":
                    if first:
                        a_in = microbatches[op.mb]
                    else:
                        a_in = self._recv("act_in", rep)
                    t0 = self.clock()
                    if last:
                        y, w = microbatches[op.mb]
                        loss_sums.append(
                            self.programs["fwd"](model, a_in, y, w))
                        out = None
                    else:
                        out = self.programs["fwd"](model, a_in)
                    self._sync()
                    t1 = self.clock()
                    saved[op.mb] = a_in
                    if out is not None:
                        self._send("act_out", out, rep)
                else:  # bwd
                    a_in = saved.pop(op.mb)
                    if last:
                        y, w = microbatches[op.mb]
                        t0 = self.clock()
                        acc, g_in = self.programs["bwd"](model, a_in, y, w,
                                                         acc)
                    else:
                        g = self._recv("grad_in", rep)
                        t0 = self.clock()
                        if first:
                            acc = self.programs["bwd"](model, a_in, g, acc)
                            g_in = None
                        else:
                            acc, g_in = self.programs["bwd"](model, a_in, g,
                                                             acc)
                    self._sync()
                    t1 = self.clock()
                    if g_in is not None and not first:
                        self._send("grad_out", g_in, rep)
                if t_start is None:
                    t_start = t0
                rep.busy_s += t1 - t0
                rep.phase_busy[op.phase] += t1 - t0
                if op.phase == "steady":
                    steady_t0 = t0 if steady_t0 is None else steady_t0
                    steady_t1 = t1
            t0 = self.clock()
            state = self.programs["update"](state, acc, total)
            self._sync()
            t1 = self.clock()
        rep.launches = dict(counts)
        rep.busy_s += t1 - t0
        rep.window_s = t1 - (t_start if t_start is not None else t0)
        if steady_t0 is not None:
            rep.steady_window_s = steady_t1 - steady_t0
            rep.steady_busy_s = rep.phase_busy["steady"]
        return state, rep, loss_sums

    def run_eval(self, state, microbatches):
        """Forward-only microbatch pipeline for validation: stage 0
        feeds x microbatches, the last stage returns the 6 eval sums
        summed over the microbatches; middle stages relay (the runner
        passes a list of Nones of the microbatch count)."""
        from dct_tpu_torch.ops.flash_attention import counted_launches

        k, p = self.k, self.n_stages
        first, last = k == 0, k == p - 1
        rep = StageReport(stage=k)
        sums = None
        if microbatches is None:
            raise ValueError("middle stages need an explicit count")
        with counted_launches() as counts:
            for mb in range(len(microbatches)):
                if first:
                    a_in = microbatches[mb]
                else:
                    a_in = self._recv("act_in", rep)
                if last:
                    y, w = microbatches[mb]
                    out = self.programs["eval"](state.model, a_in, y, w)
                    self._sync()
                    sums = (out if sums is None
                            else tuple(a + b for a, b in zip(sums, out)))
                else:
                    out = self.programs["fwd"](state.model, a_in)
                    self._sync()
                    self._send("act_out", out, rep)
        rep.launches = dict(counts)
        return sums, rep


# ----------------------------------------------------------------------
# The in-process runner: one controller THREAD per stage, each on its
# card — stages genuinely overlap on disjoint cards, and the per-stage
# reports carry real fill/steady/drain/transfer-wait windows.


def split_microbatches(arr, m: int) -> list:
    b = arr.shape[0]
    if b % m:
        raise MpmdSpecError(f"batch {b} does not tile n_microbatches={m}")
    return [arr[i * (b // m):(i + 1) * (b // m)] for i in range(m)]


def step_total(y, w) -> float:
    """The loss normalizer of a step: the weight sum times the supervised
    positions per row (1 for the pooled head), at least 1."""
    positions = 1
    for d in np.asarray(y).shape[1:]:
        positions *= d
    return max(float(np.asarray(w, np.float32).sum()) * positions, 1.0)


class MpmdRunner:
    """One thread per stage over ``devices`` (one card each, or one
    shared device); ``stage_states`` and ``programs`` per stage."""

    def __init__(
        self, spec: MpmdSpec, stage_states: list, programs: list,
        devices: list, *, clock=time.perf_counter,
    ):
        self.spec = spec
        self.states = list(stage_states)
        self.programs = programs
        self.devices = [torch.device(d) for d in devices]
        self.clock = clock
        self.ops = build_schedule(
            spec.n_stages, spec.n_microbatches, spec.schedule
        )
        self.last_reports: list[StageReport] = []
        self.last_eval_reports: list[StageReport] = []

    def _executors(self):
        p = self.spec.n_stages
        act_ch = [QueueChannel() for _ in range(p - 1)]
        grad_ch = [QueueChannel() for _ in range(p - 1)]
        execs = []
        for k in range(p):
            channels = {}
            if k > 0:
                channels["act_in"] = act_ch[k - 1]
                # The SENDER moves the payload onto the consumer's card.
                channels["grad_out"] = _PlacingChannel(
                    grad_ch[k - 1], self.devices[k - 1]
                )
            if k < p - 1:
                channels["act_out"] = _PlacingChannel(
                    act_ch[k], self.devices[k + 1]
                )
                channels["grad_in"] = grad_ch[k]
            execs.append(
                StageExecutor(
                    k, p, self.programs[k], channels=channels,
                    transfer_timeout_s=self.spec.transfer_timeout_s,
                    clock=self.clock, device=self.devices[k],
                )
            )
        return execs

    def _split_mb(self, arr, dtype=None):
        return [torch.as_tensor(a if dtype is None else a.astype(dtype))
                for a in split_microbatches(np.asarray(arr),
                                            self.spec.n_microbatches)]

    def _stage_inputs(self, k, xs, ys, ws):
        p, dev = self.spec.n_stages, self.devices[k]
        if k == 0:
            return [a.to(dev) for a in xs]
        if k == p - 1:
            return [(y.to(dev), w.to(dev)) for y, w in zip(ys, ws)]
        return [None] * len(xs)

    def _run_threads(self, fn, what: str) -> list:
        p = self.spec.n_stages
        results: list = [None] * p
        errors: list = []

        def run(k):
            try:
                if self.devices[k].type == "cuda":
                    torch.cuda.set_device(self.devices[k])
                results[k] = fn(k)
            except BaseException as e:  # noqa: BLE001 — joined below
                errors.append((k, e))

        threads = [threading.Thread(target=run, args=(k,), daemon=True)
                   for k in range(p)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.spec.transfer_timeout_s * 4)
        if errors:
            k, e = errors[0]
            raise RuntimeError(f"MPMD {what}stage {k} failed: {e}") from e
        stuck = [k for k, t in enumerate(threads) if t.is_alive()]
        if stuck:
            raise MpmdTransferTimeout(
                f"{what}stage thread(s) {stuck} still running past "
                f"{self.spec.transfer_timeout_s * 4}s — a wedged "
                "inter-stage dependency"
            )
        return results

    def train_step(self, x, y, w):
        """One optimizer step over the whole batch: returns
        (mean_loss, wall_s); per-stage reports in ``last_reports``."""
        xs = self._split_mb(x, np.float32)
        ys = self._split_mb(y)
        ws = self._split_mb(w, np.float32)
        total = step_total(y, w)
        execs = self._executors()

        def run(k):
            return execs[k].run_step(
                self.ops[k], self.states[k],
                self._stage_inputs(k, xs, ys, ws), total)

        t0 = self.clock()
        results = self._run_threads(run, "")
        wall = self.clock() - t0
        p = self.spec.n_stages
        self.last_reports = [results[k][1] for k in range(p)]
        for k in range(p):
            self.states[k] = results[k][0]
        loss_sums = results[p - 1][2]
        loss = float(sum(float(s) for s, _c in loss_sums) / total)
        return loss, wall

    def eval_pass(self, x, y, w):
        """Validation sums over one batch (forward-only pipeline):
        (loss_sum, acc_sum, count, tp, fp, fn) as floats."""
        xs = self._split_mb(x, np.float32)
        ys = self._split_mb(y)
        ws = self._split_mb(w, np.float32)
        execs = self._executors()

        def run(k):
            return execs[k].run_eval(self.states[k],
                                     self._stage_inputs(k, xs, ys, ws))

        results = self._run_threads(run, "eval ")
        self.last_eval_reports = [r[1] for r in results]
        return tuple(float(s) for s in results[-1][0])

    def step_bubble(self, wall_s: float) -> dict:
        """Bubble accounting from the last step's per-stage reports:
        whole-step bubble, steady-state bubble, and per-stage phase
        attribution (the ``mpmd.step_report`` payload)."""
        p = self.spec.n_stages
        reps = self.last_reports
        busy = sum(r.busy_s for r in reps)
        step_bubble = 1.0 - busy / (p * wall_s) if wall_s > 0 else 0.0
        utils = [
            r.steady_busy_s / r.steady_window_s
            for r in reps
            if r.steady_window_s > 0
        ]
        steady_bubble = 1.0 - (sum(utils) / len(utils)) if utils else 0.0
        return {
            "schedule": self.spec.schedule,
            "n_stages": p,
            "n_microbatches": self.spec.n_microbatches,
            "wall_s": round(wall_s, 6),
            "step_bubble": round(max(0.0, step_bubble), 6),
            "steady_bubble": round(max(0.0, steady_bubble), 6),
            "analytic_bubble": round(
                analytic_bubble(p, self.spec.n_microbatches), 6
            ),
            "stages": [stage_row(r) for r in reps],
        }


def stage_row(r: StageReport) -> dict:
    """A stage's line of a step report."""
    return {
        "stage": r.stage,
        "busy_s": round(r.busy_s, 6),
        "transfer_wait_s": round(r.transfer_wait_s, 6),
        "send_s": round(r.send_s, 6),
        "fill_s": round(r.phase_busy["fill"], 6),
        "steady_s": round(r.phase_busy["steady"], 6),
        "drain_s": round(r.phase_busy["drain"], 6),
        "launches": dict(r.launches),
    }


class _PlacingChannel:
    """Send-side wrapper: move the payload onto the consumer's card
    before enqueueing (the explicit inter-card transfer; PyTorch orders a
    cross-device copy on both devices' current streams, so the
    consumer's next program waits for it on the device, not the
    host)."""

    def __init__(self, inner, device):
        self._inner = inner
        self._device = torch.device(device)

    def send(self, payload) -> None:
        self._inner.send(payload.to(self._device))

    def recv(self, timeout: float):
        return self._inner.recv(timeout)
