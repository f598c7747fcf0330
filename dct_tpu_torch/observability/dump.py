"""Live per-epoch training metrics on the metrics plane (the
``LiveTrainMetrics`` half of ``dct_tpu/observability/dump.py``).

When ``DCT_METRICS_DIR`` arms the plane, the trainer's coordinator
publishes its per-epoch gauges from :class:`LiveTrainMetrics` while the run
is alive. The reference's end-of-run Prometheus textfile dump
(``write_train_metrics_prom``) and the goodput ledger behind
``goodput_fraction`` are ROADMAP Queue A item 27: the port's trainer passes
``goodput_fraction=None``.
"""

from __future__ import annotations

import math

from dct_tpu_torch.observability.metrics import MetricsRegistry


class LiveTrainMetrics:
    """Per-epoch live metrics for the coordinator rank: val-loss,
    goodput, step time and grad norm reach the metrics plane at epoch
    cadence while the run is alive, under the family names and aggs of
    the reference's end-of-run dump and its ``proc`` (``train-rank0``).

    Telemetry-only by construction: nothing here touches model code,
    RNG or device state, which keeps the loss trajectory bitwise
    identical armed vs off.
    """

    def __init__(self, obs, *, run_id: str, proc: str):
        from dct_tpu_torch.observability.aggregate import SnapshotPublisher

        self._labels = {"run_id": run_id}
        reg = MetricsRegistry()
        self._val_loss = reg.gauge(
            "dct_train_val_loss", "Final validation loss of the run.",
            agg="last",
        )
        self._goodput = reg.gauge(
            "dct_train_goodput_fraction",
            "Productive (train_step + eval) seconds over wall seconds.",
            agg="last",
        )
        self._sps = reg.gauge(
            "dct_train_samples_per_sec",
            "Mean training throughput over the run.", agg="last",
        )
        self._step_s = reg.gauge(
            "dct_train_step_seconds",
            "Mean optimizer-step wall seconds over the last epoch.",
            agg="last",
        )
        self._grad_norm = reg.gauge(
            "dct_train_grad_norm",
            "Last observed gradient global norm.", agg="last",
        )
        self._epochs = reg.counter(
            "dct_train_epochs_total", "Epochs completed by this run.",
        )
        self.registry = reg
        self.publisher = SnapshotPublisher(
            reg, obs.metrics_dir, proc=proc,
            interval_s=obs.metrics_publish_s,
        )

    def epoch_end(
        self,
        *,
        val_loss: float | None = None,
        goodput_fraction: float | None = None,
        samples_per_sec: float | None = None,
        step_seconds: float | None = None,
        grad_norm: float | None = None,
    ) -> None:
        """Record one epoch; never raises (telemetry discipline)."""
        try:
            L = self._labels
            if val_loss is not None and math.isfinite(val_loss):
                self._val_loss.set(float(val_loss), L)
            if goodput_fraction is not None:
                self._goodput.set(float(goodput_fraction), L)
            if samples_per_sec is not None:
                self._sps.set(float(samples_per_sec), L)
            if step_seconds is not None:
                self._step_s.set(float(step_seconds), L)
            if grad_norm is not None and math.isfinite(grad_norm):
                self._grad_norm.set(float(grad_norm), L)
            self._epochs.inc(1, L)
            # Epoch cadence is orders slower than the publish throttle:
            # publish directly so every epoch lands on the timeline.
            self.publisher.publish()
        except Exception:  # noqa: BLE001 — telemetry never fails the run
            pass

    def close(self) -> None:
        """Retire the live snapshot (in the reference the final dump,
        written next, re-creates the same proc's snapshot as terminal)."""
        try:
            self.publisher.close(final=False)
        except Exception:  # noqa: BLE001
            pass


def live_train_metrics(obs, *, run_id: str, rank: int):
    """Coordinator-only builder; None when the plane is unarmed."""
    if rank != 0 or not obs.enabled or not obs.metrics_dir:
        return None
    try:
        return LiveTrainMetrics(
            obs, run_id=run_id, proc=f"train-rank{rank}"
        )
    except Exception:  # noqa: BLE001 — telemetry never fails the run
        return None
