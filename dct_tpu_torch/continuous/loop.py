"""The always-on loop: overlapped ETL / train / gate / deploy (counterpart
of ``dct_tpu/continuous/loop.py``).

``AlwaysOnLoop.run()`` drives three concurrent actors over shared,
atomically published artifacts:

- the TRAIN PUMP (this thread): back-to-back rounds of
  ``epochs_per_round`` epochs, each EXTENDING one optimizer trajectory
  (``resume`` semantics: the serial trainer's continuation path, so a
  two-round loop trains what one unbroken fit trains). In ``supervised``
  mode (the default) each round is a training world of
  ``python -m dct_tpu_torch.train_job`` under
  :meth:`~dct_tpu_torch.launch.launcher.LocalProcessLauncher.supervise`
  (crash, hang and preemption healing; ``DCT_WORLD_SIZE`` ranks);
  ``inline`` runs ``Trainer.fit`` in-process on the loop's device.
- the INGEST WATCHER (daemon thread): digest-polls the raw staging CSV and
  feeds the incremental ETL, so a fresh generation is published while
  training computes. A loop started before its staging file exists waits
  for the first generation before round 1. ``DCT_INGEST_MODE=stream``
  raises: item 24.
- the PROMOTION EVALUATOR (daemon thread): watches the deploy-tier best
  checkpoint and walks each new one through gate + rollout against the
  live champion, MID-RUN.

:func:`run_episodic_cycle` is the serial comparator built from the same
primitives: ETL, then a round, then one evaluator pass.

Shutdown: :meth:`AlwaysOnLoop.request_stop` (``loop_job`` calls it on
SIGTERM between rounds) stops the loop after the round in flight, then
joins both threads, runs one final evaluator sweep over what the last
round published, and returns the session summary (also the ``loop.stop``
event). A SIGTERM that lands during a round reaches the trainer: in a
supervised round through the supervisor (the ranks finish their span, save
and exit 75), in an inline round on the main thread through the round's
:class:`~dct_tpu_torch.resilience.preempt.PreemptionGuard` (the fit stops
at its next safe point with a durable resume snapshot); either way the
loop drains with reason ``preempted``.

Multi-tenant hooks (:mod:`dct_tpu_torch.scheduler`): ``round_gate`` is
consulted before EVERY round and blocks until the scheduler grants a round
lease (False: the session is draining); ``on_round`` receives each round's
record (the lease release); ``extra_round_env`` rides into every
supervised round's ranks (the tenant's ``DCT_*`` overrides) beneath the
loop's own keys; ``launcher_kwargs`` gives each tenant's worlds their own
coordinator port. :meth:`AlwaysOnLoop.preempt_round` revokes the round in
flight gracefully: the trainer finishes its step or span and saves, the
round ends early (``preempted`` in its record) and the loop returns to the
gate.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time

from dct_tpu_torch.config import RunConfig

#: The directory that holds the ``dct_tpu_torch`` package: a supervised
#: round's ranks import it from there.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _round_config(cfg: RunConfig, epochs: int) -> RunConfig:
    """One training round's config: the loop's epoch quantum with
    resume ALWAYS on (every round extends the same trajectory)."""
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, epochs=epochs, resume=True),
    )


def _check_modes(cfg: RunConfig) -> None:
    if cfg.loop.train_mode not in ("inline", "supervised"):
        raise ValueError(f"unknown DCT_LOOP_TRAIN_MODE "
                         f"{cfg.loop.train_mode!r} (inline or supervised)")
    if cfg.stream.mode == "stream":
        raise NotImplementedError(
            "DCT_INGEST_MODE=stream (the partitioned event log and its "
            "exactly-once stream ETL) is not ported to dct_tpu_torch yet: "
            "ROADMAP Queue A item 24. Use DCT_INGEST_MODE=poll.")
    if cfg.stream.mode != "poll":
        raise ValueError(f"unknown DCT_INGEST_MODE {cfg.stream.mode!r} "
                         "(poll or stream)")


class AlwaysOnLoop:
    """The loop runtime. Construct with a full :class:`RunConfig`
    (``cfg.loop`` carries the loop knobs) and the device the rounds and
    the gate's accelerator engine run on (``cuda:0`` when None);
    ``client`` defaults to a
    :class:`~dct_tpu_torch.deploy.local.LocalEndpointClient` persisted
    beside the packages dir, so a relaunched loop sees its deployed
    champion."""

    def __init__(
        self,
        cfg: RunConfig,
        *,
        device=None,
        client=None,
        on_round=None,
        round_gate=None,
        extra_round_env=None,
        launcher_kwargs=None,
    ):
        from dct_tpu_torch.device import resolve_device
        from dct_tpu_torch.observability.events import (
            EventLog,
            current_run_id,
        )

        _check_modes(cfg)
        self.cfg = cfg
        self.loop_cfg = cfg.loop
        self.device = resolve_device(device)
        self._on_round = on_round
        self._round_gate = round_gate
        self._extra_round_env = dict(extra_round_env or {})
        self._launcher_kwargs = dict(launcher_kwargs or {})
        # Scheduler-initiated graceful ROUND preemption: set by
        # preempt_round(); the in-flight round checkpoints and ends early,
        # and the loop returns to the gate instead of draining.
        self._round_preempt = threading.Event()
        self._inline_guard = None
        self.preempted_rounds = 0
        # One run-correlation ID for the session: every round's ranks and
        # the loop's own records carry it.
        self.run_id = cfg.obs.run_id or current_run_id()
        cfg.obs.run_id = self.run_id
        self.events = EventLog(
            os.path.join(cfg.obs.events_dir, "events.jsonl")
            if cfg.obs.enabled and cfg.obs.events_dir else None,
            run_id=self.run_id)
        # The drill a supervised round's ranks run; dropped once it has
        # provably fired and been healed (see _run_round_supervised).
        self._fault_spec = cfg.resilience.fault_spec
        if client is None:
            from dct_tpu_torch.deploy.local import LocalEndpointClient

            os.makedirs(self.loop_cfg.packages_dir, exist_ok=True)
            client = LocalEndpointClient(
                state_path=os.path.join(
                    self.loop_cfg.packages_dir, "endpoint_state.json"
                )
            )
        self.client = client
        from dct_tpu_torch.continuous.evaluator import PromotionEvaluator
        from dct_tpu_torch.continuous.ingest import IngestWatcher

        self.ingest = IngestWatcher(
            cfg.data.raw_csv, cfg.data.processed_dir,
            poll_s=self.loop_cfg.poll_s,
        )
        self.evaluator = PromotionEvaluator(
            cfg.data.models_dir, self.loop_cfg.packages_dir,
            client=self.client, endpoint=self.loop_cfg.endpoint,
            processed_dir=cfg.data.processed_dir,
            soak_s=self.loop_cfg.soak_s, poll_s=self.loop_cfg.eval_poll_s,
            device=self.device,
        )
        self._stop = threading.Event()
        self.stop_reason: str | None = None
        self.rounds = 0
        self.round_results: list[dict] = []
        self.train_epoch_wall_s = 0.0
        self.train_samples_per_sec: list[float] = []

    # -- control --------------------------------------------------------
    def request_stop(self, reason: str = "requested") -> None:
        if self.stop_reason is None:
            self.stop_reason = reason
        self._stop.set()

    @property
    def stopping(self) -> bool:
        return self._stop.is_set()

    def preempt_round(self) -> None:
        """Gracefully preempt the IN-FLIGHT round (the scheduler's lease
        revocation): the trainer finishes its step or span and makes the
        resume snapshot durable, then the loop returns to the round gate
        with the session alive. A no-op when no round runs (the flag is
        cleared at the next round's start)."""
        self._round_preempt.set()
        guard = self._inline_guard
        if guard is not None:
            guard.request()

    # -- training rounds ------------------------------------------------
    def _run_round_inline(self) -> dict:
        """One in-process round. Its record's ``goodput_s`` is the sum of
        the fit's ``epoch_seconds`` (the port's measured train time), which
        stands in for the goodput ledger's ``train_step`` category that
        the reference books (ROADMAP Queue A item 27)."""
        from dct_tpu_torch.resilience.preempt import PreemptionGuard
        from dct_tpu_torch.train.trainer import Trainer

        cfg = _round_config(self.cfg, self.loop_cfg.epochs_per_round)
        # The loop owns the round's guard, so preempt_round() can request
        # a graceful stop from another thread (on the main thread the
        # guard also takes SIGTERM, as a trainer-built one would).
        guard = PreemptionGuard()
        self._inline_guard = guard
        if self._round_preempt.is_set():
            guard.request()
        try:
            try:
                result = Trainer(cfg, device=self.device,
                                 preempt_guard=guard).fit()
            except FileNotFoundError:
                # The ingest thread's full-rebuild swap has a two-rename
                # window with no parquet dir; a round starting inside it
                # retries instead of ending the session.
                time.sleep(0.2)
                result = Trainer(cfg, device=self.device,
                                 preempt_guard=guard).fit()
        finally:
            self._inline_guard = None
        epoch_s = float(sum(result.epoch_seconds))
        self.train_epoch_wall_s += epoch_s
        if result.steady_samples_per_sec:
            self.train_samples_per_sec.append(result.steady_samples_per_sec)
        return {
            "mode": "inline",
            "epochs": self.loop_cfg.epochs_per_round,
            "val_loss": result.val_loss,
            "val_acc": result.val_acc,
            "train_losses": [h["train_loss"] for h in result.history],
            "val_losses": [h["val_loss"] for h in result.history],
            "epoch_s": round(epoch_s, 4),
            "goodput_s": round(epoch_s, 4),
            "best_model_path": result.best_model_path,
        }

    def _run_round_supervised(self) -> dict:
        from dct_tpu_torch.launch.launcher import LocalProcessLauncher
        from dct_tpu_torch.resilience.faults import FAULT_CRASH_EXIT

        world_size = int(self._extra_round_env.get("DCT_WORLD_SIZE")
                         or os.environ.get("DCT_WORLD_SIZE", "1") or 1)
        # The ranks rebuild RunConfig.from_env(): every path and knob THIS
        # loop was constructed with travels, or a programmatic RunConfig
        # would train into env-default dirs while the watcher and the
        # evaluator look at the configured ones; the mesh and sharding
        # knobs too, so that every rank builds the same grid and layout.
        # (The reference forwards its stream keys as well; the port's
        # ranks refuse the stream ingest: train_job.refuse_unported_env.)
        env = {
            "DCT_EPOCHS": str(self.loop_cfg.epochs_per_round),
            "DCT_RESUME": "1",
            "DCT_RUN_ID": self.run_id,
            "DCT_PROCESSED_DIR": self.cfg.data.processed_dir,
            "DCT_RAW_CSV": self.cfg.data.raw_csv,
            "DCT_MODELS_DIR": self.cfg.data.models_dir,
            "DCT_EVENTS_DIR": self.cfg.obs.events_dir,
            "DCT_HEARTBEAT_DIR": self.cfg.obs.heartbeat_dir,
            "DCT_FAULT_SPEC": self._fault_spec,
            "DCT_MESH_DATA": str(self.cfg.mesh.data),
            "DCT_MESH_MODEL": str(self.cfg.mesh.model),
            "DCT_MESH_SEQ": str(self.cfg.mesh.seq),
            "DCT_MESH_PIPE": str(self.cfg.mesh.pipe),
            "DCT_SHARD_OPT_STATE": "1" if self.cfg.train.shard_opt_state
            else "0",
            "DCT_SHARD_PARAMS": "1" if self.cfg.train.shard_params else "0",
            "PYTHONPATH": os.pathsep.join(
                p for p in (_PKG_ROOT, os.environ.get("PYTHONPATH")) if p),
        }
        if self.device.type == "cpu":
            env["DCT_DEVICE"] = "cpu"
        # Env-only: an operator's rule overrides ride along when set.
        if os.environ.get("DCT_SHARD_RULES"):
            env["DCT_SHARD_RULES"] = os.environ["DCT_SHARD_RULES"]
        # Per-tenant overrides (scheduler mode) ride UNDER the loop's own
        # keys: the tenant env shaped this loop's cfg in the first place,
        # and the cfg is the round's contract.
        env = {**self._extra_round_env, **env}
        res = LocalProcessLauncher(**self._launcher_kwargs).supervise(
            [sys.executable, "-m", "dct_tpu_torch.train_job"],
            world_size=world_size,
            env=env,
            max_restarts=self.cfg.resilience.max_restarts,
            backoff_s=self.cfg.resilience.restart_backoff_s,
            backoff_factor=self.cfg.resilience.restart_backoff_factor,
            jitter=self.cfg.resilience.restart_jitter,
            preempt_event=self._round_preempt,
        )
        # A drill is per session: once the plan provably fired (a rank
        # died with the injected-crash code) and was healed in this round,
        # later rounds run clean; otherwise a resumed trajectory past the
        # trigger epoch would re-fire it every round. A restart the drill
        # did not cause leaves a drill that has yet to fire armed.
        if res.restarts and any(r.returncode == FAULT_CRASH_EXIT
                                for a in res.attempts for r in a.results):
            self._fault_spec = ""
        rec = {
            "mode": "supervised",
            "epochs": self.loop_cfg.epochs_per_round,
            "attempts": len(res.attempts),
            "restarts": res.restarts,
            "classification": res.classification,
        }
        if res.attempts:
            rec["attempt_wall_s"] = round(res.attempts[-1].wall_seconds, 3)
            # Quota accounting: the last attempt's wall is the round's
            # useful window; everything before it was healing.
            rec["goodput_s"] = rec["attempt_wall_s"]
        if res.classification == "preempted" and not res.success:
            if self._round_preempt.is_set() and not self._stop.is_set():
                # Lease revocation: the world saved and exited 75; the
                # round ends early and the loop lives.
                rec["preempted"] = True
                return rec
            # The supervisor caught SIGTERM (it owns the process signals
            # while a round is in flight): the world saved its resume
            # snapshot; drain.
            self.request_stop("preempted")
        elif not res.success:
            self.request_stop(f"train_{res.classification}")
            raise RuntimeError(
                f"supervised round gave up: {res.classification} "
                f"(restarts={res.restarts})")
        return rec

    def _budget_exhausted(self, t0: float) -> str | None:
        lc = self.loop_cfg
        if lc.max_rounds and self.rounds >= lc.max_rounds:
            return "max_rounds"
        if lc.max_wall_s and time.time() - t0 >= lc.max_wall_s:
            return "max_wall_s"
        if lc.max_promotions and len(
            self.evaluator.promotions
        ) >= lc.max_promotions:
            return "max_promotions"
        return None

    # -- the loop --------------------------------------------------------
    def run(self) -> dict:
        """Run until a stop budget, :meth:`request_stop`, or SIGTERM
        (through ``loop_job``); returns the session summary."""
        from dct_tpu_torch.resilience.preempt import PreemptedError

        lc = self.loop_cfg
        t0 = time.time()
        self.events.emit(
            "loop", "loop.start", train_mode=lc.train_mode,
            epochs_per_round=lc.epochs_per_round, endpoint=lc.endpoint,
            poll_s=lc.poll_s, eval_poll_s=lc.eval_poll_s,
            max_rounds=lc.max_rounds, max_wall_s=lc.max_wall_s,
            max_promotions=lc.max_promotions)
        threads = []
        ingest_armed = lc.poll_s > 0 and bool(self.cfg.data.raw_csv)
        if ingest_armed:
            # Prime the snapshot BEFORE round 1: a cold start must not
            # race the first fit against an absent parquet.
            self.ingest.check_once()
            t = threading.Thread(
                target=self.ingest.run, args=(self._stop,),
                name="loop-ingest", daemon=True,
            )
            t.start()
            threads.append(t)
        if lc.eval_poll_s > 0:
            t = threading.Thread(
                target=self.evaluator.run, args=(self._stop,),
                name="loop-evaluator", daemon=True,
            )
            t.start()
            threads.append(t)
        if ingest_armed:
            # Cold start before the staging file exists: idle at the poll
            # cadence until the watcher publishes the first generation
            # instead of failing round 1 on an absent parquet (the
            # reference does this for its stream ingest; its poll mode
            # fails the round). The stop budgets bound the wait.
            from dct_tpu_torch.etl.preprocess import read_etl_state

            while (not self._stop.is_set()
                   and self._budget_exhausted(t0) is None
                   and not read_etl_state(
                       self.cfg.data.processed_dir).get("generation")):
                self._stop.wait(max(lc.poll_s, 0.05))
        error: str | None = None
        try:
            while not self._stop.is_set():
                reason = self._budget_exhausted(t0)
                if reason is not None:
                    self.request_stop(reason)
                    break
                if self._round_gate is not None:
                    # Scheduler mode: block until a round lease is granted.
                    # False = the session is draining.
                    try:
                        granted = self._round_gate()
                    except Exception as e:  # noqa: BLE001 — a broken gate stops THIS loop only
                        error = f"{type(e).__name__}: {e}"[:300]
                        self.events.emit("loop", "loop.error",
                                         where="round_gate", error=error)
                        self.request_stop("gate_error")
                        break
                    if not granted:
                        self.request_stop("gate_closed")
                        break
                self._round_preempt.clear()
                round_t0 = time.time()
                try:
                    rec = (self._run_round_inline()
                           if lc.train_mode == "inline"
                           else self._run_round_supervised())
                except PreemptedError as e:
                    if self._round_preempt.is_set() and not self._stop.is_set():
                        # Lease revocation of an inline round: the trainer
                        # saved a durable resume snapshot; the round ends
                        # early and the loop returns to the gate. Its
                        # completed epochs are kept, so they count.
                        rec = {"mode": lc.train_mode,
                               "epochs": lc.epochs_per_round,
                               "preempted": True,
                               "goodput_s": round(e.epoch_seconds, 4)}
                    else:
                        # The inline round honored SIGTERM: the resume
                        # snapshot is durable; drain.
                        self.request_stop("preempted")
                        break
                except Exception as e:  # noqa: BLE001 — name it, then stop cleanly
                    error = f"{type(e).__name__}: {e}"[:300]
                    self.events.emit("loop", "loop.error", where="train",
                                     error=error)
                    self.request_stop("train_error")
                    if self._on_round is not None:
                        # The scheduler must still release the lease the
                        # failed round held.
                        try:
                            self._on_round({"error": error})
                        except Exception:  # noqa: BLE001 — a bad callback must not mask the error
                            pass
                    break
                rec["round_wall_s"] = round(time.time() - round_t0, 3)
                self.rounds += 1
                if rec.get("preempted"):
                    self.preempted_rounds += 1
                rec["round"] = self.rounds
                self.round_results.append(rec)
                self.events.emit("loop", "loop.round", **{
                    k: v for k, v in rec.items()
                    if k not in ("train_losses", "val_losses")})
                if self._on_round is not None:
                    try:
                        self._on_round(rec)
                    except Exception:  # noqa: BLE001 — a bad callback must not kill the loop
                        pass
        finally:
            self.request_stop("completed")
            for t in threads:
                t.join(timeout=max(60.0, 4 * lc.soak_s + 30.0))
            if error is None and not any(t.is_alive() for t in threads):
                # Drain: whatever the final round published still gets
                # one evaluator pass (bounded: one gate + rollout). Skipped
                # if a join timed out: the evaluator thread may still be
                # mid-pass, and a second concurrent rollout against the
                # same endpoint is worse than a missed final sweep.
                self.evaluator.check_once()
            summary = self.summary(wall_s=time.time() - t0, error=error)
            self.events.emit("loop", "loop.stop", **summary)
        return summary

    def summary(self, *, wall_s: float, error: str | None = None) -> dict:
        promos = self.evaluator.promotions
        fresh = [
            p["freshness_s"] for p in promos
            if p.get("freshness_s") is not None
        ]
        sps = self.train_samples_per_sec
        return {
            "reason": self.stop_reason,
            "error": error,
            "rounds": self.rounds,
            "preempted_rounds": self.preempted_rounds,
            "wall_s": round(wall_s, 3),
            "ingested_generations": self.ingest.processed,
            "promotions": len(promos),
            "held": len(self.evaluator.held),
            "evaluator_errors": self.evaluator.errors,
            "ingest_errors": self.ingest.errors,
            "freshness_s": [round(f, 3) for f in fresh],
            "mean_freshness_s": (
                round(sum(fresh) / len(fresh), 3) if fresh else None
            ),
            # The inline rounds' epoch wall time (the port's trainer times
            # epochs; the reference's goodput ledger of step time is item
            # 27) as a fraction of the loop's; supervised rounds account
            # in their ranks' events.
            "train_epoch_wall_s": round(self.train_epoch_wall_s, 3),
            "goodput": (
                round(self.train_epoch_wall_s / wall_s, 4)
                if wall_s > 0 else None
            ),
            "train_samples_per_sec": (
                round(sum(sps) / len(sps), 1) if sps else None
            ),
        }


# ----------------------------------------------------------------------
# The episodic comparator: the SAME primitives, strictly serial.


def run_episodic_cycle(
    cfg: RunConfig,
    *,
    client,
    evaluator,
    device=None,
) -> dict:
    """One serial ETL -> train -> gate -> deploy cycle: the reference's
    episodic DAG semantics built from the loop's own primitives.
    ``evaluator`` is a
    :class:`~dct_tpu_torch.continuous.evaluator.PromotionEvaluator` reused
    across cycles (its seen-checkpoint state and package counter persist,
    as the loop's do) and deploying to ``client`` (the reference's
    signature; the evaluator holds the client). The round trains on
    ``device`` (``cuda:0`` when None)."""
    from dct_tpu_torch.etl.preprocess import (
        preprocess_csv_to_parquet,
        read_etl_state,
    )
    from dct_tpu_torch.train.trainer import Trainer

    t0 = time.time()
    preprocess_csv_to_parquet(
        cfg.data.raw_csv, cfg.data.processed_dir, incremental=True
    )
    t_etl = time.time()
    result = Trainer(_round_config(cfg, cfg.loop.epochs_per_round),
                     device=device).fit()
    t_train = time.time()
    promo = evaluator.check_once()
    t_done = time.time()
    state = read_etl_state(cfg.data.processed_dir)
    arrival = state.get("arrival_ts")
    return {
        "cycle_s": round(t_done - t0, 4),
        "etl_s": round(t_etl - t0, 4),
        "train_s": round(t_train - t_etl, 4),
        "deploy_s": round(t_done - t_train, 4),
        "train_epoch_wall_s": float(sum(result.epoch_seconds)),
        "train_samples_per_sec": result.steady_samples_per_sec,
        "promoted": promo is not None,
        "generation": state.get("generation"),
        "freshness_s": (
            round(t_done - arrival, 4)
            if promo is not None and arrival else None
        ),
        "val_loss": result.val_loss,
        "best_model_path": result.best_model_path,
    }
