"""The always-on loop: overlapped ETL / train / gate / deploy (counterpart
of ``dct_tpu/continuous/loop.py``).

``AlwaysOnLoop.run()`` drives three concurrent actors over shared,
atomically published artifacts:

- the TRAIN PUMP (this thread): back-to-back rounds of
  ``epochs_per_round`` epochs, each EXTENDING one optimizer trajectory
  (``resume`` semantics: the serial trainer's continuation path, so a
  two-round loop trains what one unbroken fit trains). ``inline`` mode runs
  ``Trainer.fit`` in-process on the loop's device. ``supervised`` mode
  (each round under the process supervisor, ``launch/launcher.py``) raises
  ``NotImplementedError``: ROADMAP Queue A item 20.
- the INGEST WATCHER (daemon thread): digest-polls the raw staging CSV and
  feeds the incremental ETL, so a fresh generation is published while
  training computes. ``DCT_INGEST_MODE=stream`` raises: item 24.
- the PROMOTION EVALUATOR (daemon thread): watches the deploy-tier best
  checkpoint and walks each new one through gate + rollout against the
  live champion, MID-RUN.

:func:`run_episodic_cycle` is the serial comparator built from the same
primitives: ETL, then a round, then one evaluator pass.

Shutdown: :meth:`AlwaysOnLoop.request_stop` (``loop_job`` calls it on
SIGTERM) lets the round in flight finish, its checkpoints published (the
reference's in-round preemption guard, which cuts a round short at a
durable snapshot, is item 28), then joins both threads, runs one final
evaluator sweep over what the last round published, and returns the
session summary. The reference's ``loop.*`` events are item 27; the
summary carries their fields.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from dct_tpu_torch.config import RunConfig


def _round_config(cfg: RunConfig, epochs: int) -> RunConfig:
    """One training round's config: the loop's epoch quantum with
    resume ALWAYS on (every round extends the same trajectory)."""
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, epochs=epochs, resume=True),
    )


def _check_modes(cfg: RunConfig) -> None:
    if cfg.loop.train_mode == "supervised":
        raise NotImplementedError(
            "DCT_LOOP_TRAIN_MODE=supervised runs each round under the "
            "process supervisor (launch/launcher.py), which is not ported "
            "to dct_tpu_torch yet: ROADMAP Queue A item 20. Use "
            "DCT_LOOP_TRAIN_MODE=inline.")
    if cfg.loop.train_mode != "inline":
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
    ):
        from dct_tpu_torch.device import resolve_device

        _check_modes(cfg)
        self.cfg = cfg
        self.loop_cfg = cfg.loop
        self.device = resolve_device(device)
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

    # -- training rounds ------------------------------------------------
    def _run_round_inline(self) -> dict:
        from dct_tpu_torch.train.trainer import Trainer

        cfg = _round_config(self.cfg, self.loop_cfg.epochs_per_round)
        try:
            result = Trainer(cfg, device=self.device).fit()
        except FileNotFoundError:
            # The ingest thread's full-rebuild swap has a two-rename
            # window with no parquet dir; a round starting inside it
            # retries instead of ending the session.
            time.sleep(0.2)
            result = Trainer(cfg, device=self.device).fit()
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
            "best_model_path": result.best_model_path,
        }

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
        lc = self.loop_cfg
        t0 = time.time()
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
        error: str | None = None
        try:
            while not self._stop.is_set():
                reason = self._budget_exhausted(t0)
                if reason is not None:
                    self.request_stop(reason)
                    break
                round_t0 = time.time()
                try:
                    rec = self._run_round_inline()
                except Exception as e:  # noqa: BLE001 — name it, then stop cleanly
                    error = f"{type(e).__name__}: {e}"[:300]
                    self.request_stop("train_error")
                    break
                rec["round_wall_s"] = round(time.time() - round_t0, 3)
                self.rounds += 1
                rec["round"] = self.rounds
                self.round_results.append(rec)
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
            # The epochs' wall time (the port's trainer times epochs; the
            # reference's goodput ledger of step time is item 27) as a
            # fraction of the loop's.
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
