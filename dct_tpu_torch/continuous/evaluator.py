"""Concurrent evaluator: mid-run promotion of the deploy-tier best
checkpoint through the champion/challenger gate (counterpart of
``dct_tpu/continuous/evaluator.py``).

For every NEW best checkpoint (``BestLastCheckpointer``'s atomically
published ``weather-best-*.ckpt``) the evaluator

1. packages it (``serving.score_gen.generate_score_package``) into its own
   challenger dir, with a ``run_info.json`` manifest stamping the
   validation split, a training-data snapshot for the drift detectors and
   the ETL generation the checkpoint trained on;
2. walks it through shadow -> gate -> canary -> gate -> full against the
   live champion with :class:`~dct_tpu_torch.deploy.rollout.
   RolloutOrchestrator`. A gate hold or rollback reverts traffic to the
   champion; training never stops either way.

Freshness: a promoted package's meta carries ``data_generation`` and
``data_arrival_ts`` (stamped by the trainer from ``etl_state.json``), so
each promotion record reports ``freshness_s`` = promote time - data
arrival. The reference also emits ``loop.promoted`` /
``loop.promotion_held`` / ``loop.error`` events (ROADMAP Queue A item 27);
here the records (:attr:`promotions`, :attr:`held`, :attr:`error_log`)
carry the same fields.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time

#: Challenger package dirs kept regardless of slot references (a just-held
#: package may still be under an operator's triage).
KEEP_PACKAGES = 4


def package_checkpoint(
    ckpt_path: str,
    package_dir: str,
    *,
    processed_dir: str | None = None,
) -> dict:
    """Build a challenger deploy package from a raw checkpoint.

    The mid-run analog of ``deploy.rollout.prepare_package`` (which
    queries the tracking store and WIPES its target): here the
    checkpoint is already on local disk and each challenger gets a
    FRESH directory — the deployed champion's package dir must survive
    the next challenger's packaging. Returns the package manifest info
    (generation, split, val metrics).
    """
    from dct_tpu_torch.deploy.rollout import (
        _split_params,
        _training_data_snapshot,
    )
    from dct_tpu_torch.serving.score_gen import generate_score_package

    os.makedirs(package_dir, exist_ok=True)
    meta = generate_score_package(ckpt_path, package_dir)
    info = {
        # The event log's run correlation is ROADMAP Queue A item 27.
        "run_correlation_id": None,
        "val_loss": meta.get("val_loss"),
        "data_generation": meta.get("data_generation"),
        "data_arrival_ts": meta.get("data_arrival_ts"),
        "data_snapshot": _training_data_snapshot(processed_dir),
        # The loop shares the trainer's process env, so the env-derived
        # split parameters ARE the trainer's (checkpoint params carry no
        # split record; the manifest is what the gate trusts).
        "split": _split_params(None),
        "source_checkpoint": os.path.basename(ckpt_path),
    }
    info_path = os.path.join(package_dir, "run_info.json")
    info_tmp = f"{info_path}.tmp.{os.getpid()}"
    with open(info_tmp, "w") as f:
        json.dump(info, f, indent=2)
    os.replace(info_tmp, info_path)
    return info


class PromotionEvaluator:
    """Watches the deploy tier and promotes mid-run.

    ``check_once`` is the unit (poll loops, the episodic comparator and
    tests all share it); :meth:`run` is the thread body. State is one
    (name, mtime_ns, size) triple — the last checkpoint considered —
    so a gate-held checkpoint is not retried until a NEW best lands.
    The newest ``KEEP_PACKAGES`` challenger dirs are kept whether or not
    a slot references them.
    """

    def __init__(
        self,
        models_dir: str,
        packages_dir: str,
        *,
        client,
        endpoint: str,
        processed_dir: str | None = None,
        soak_s: float = 5.0,
        poll_s: float = 2.0,
        gate_factory=None,
        device=None,
    ):
        self.models_dir = models_dir
        self.packages_dir = packages_dir
        self.client = client
        self.endpoint = endpoint
        self.processed_dir = processed_dir
        self.soak_s = float(soak_s)
        self.poll_s = float(poll_s)
        self._gate_factory = gate_factory
        # The device of the gate's accelerator engine (cuda:0 when None).
        self.device = device
        # Package numbering resumes past any EXISTING pkg-* dir: a
        # relaunched loop must never reuse a prior session's package
        # name — the persisted endpoint state may still point a LIVE
        # champion slot at it, and regenerating into that dir would
        # swap the champion's weights for an unvetted challenger's.
        self._counter = self._next_package_index()
        self._seen: tuple | None = None
        # Transient-failure retry budget, PER checkpoint identity: a
        # new best arriving mid-retry must get its own full budget.
        self._retries = 0
        self._retry_key: tuple | None = None
        #: promotion records: {ts, package, generation, freshness_s, ...}
        self.promotions: list[dict] = []
        self.held: list[dict] = []
        self.errors = 0
        #: failed passes: {checkpoint, parked, error}
        self.error_log: list[dict] = []

    def _next_package_index(self) -> int:
        try:
            names = os.listdir(self.packages_dir)
        except OSError:
            return 0
        indices = [
            int(n[4:]) for n in names
            if n.startswith("pkg-") and n[4:].isdigit()
        ]
        return max(indices, default=0)

    # -- deploy-tier watch ---------------------------------------------
    def _newest_best(self) -> tuple[str, tuple] | None:
        """The newest ``weather-best-*.ckpt`` (falling back to any
        non-last ``*.ckpt``) and its stat identity."""
        pats = ("weather-best-*.ckpt", "*.ckpt")
        for pat in pats:
            candidates = [
                p for p in glob.glob(os.path.join(self.models_dir, pat))
                if os.path.basename(p) != "last.ckpt"
            ]
            if not candidates:
                continue
            try:
                newest = max(candidates, key=os.path.getmtime)
                st = os.stat(newest)
            except OSError:
                return None  # replaced mid-glob: next poll retries
            return newest, (os.path.basename(newest), st.st_mtime_ns,
                            st.st_size)
        return None

    def _gate(self):
        if self._gate_factory is not None:
            return self._gate_factory()
        from dct_tpu_torch.evaluation.gates import PromotionGate

        gate = PromotionGate.from_env(device=self.device)
        if gate is not None and self.processed_dir:
            gate.processed_dir = self.processed_dir
        return gate

    # -- one evaluation pass -------------------------------------------
    def check_once(self) -> dict | None:
        """Consider the current best checkpoint; package + gate +
        promote when it is new. Returns the promotion record, or None
        (nothing new / held / errored — held and errored land in
        :attr:`held` and :attr:`error_log`)."""
        found = self._newest_best()
        if found is None:
            return None
        ckpt, key = found
        if key == self._seen:
            return None
        if key != self._retry_key:
            self._retry_key = key
            self._retries = 0
        try:
            rec = self._promote(ckpt)
        except Exception as e:  # noqa: BLE001 — the loop must outlive one bad pass
            self.errors += 1
            # A TRANSIENT failure (disk pressure mid-packaging, tracker
            # hiccup) must not strand a better model undeployed until
            # the next best happens to land: retry this checkpoint a
            # few polls before parking it (a deterministic failure —
            # corrupt checkpoint — must not re-fire every poll forever).
            self._retries += 1
            parked = self._retries >= 3
            if parked:
                self._seen = key
                self._retries = 0
            self.error_log.append({
                "checkpoint": os.path.basename(ckpt), "parked": parked,
                "error": f"{type(e).__name__}: {e}"[:300],
            })
            return None
        self._seen = key
        self._retries = 0
        return rec

    def _promote(self, ckpt: str) -> dict | None:
        from dct_tpu_torch.deploy.rollout import RolloutOrchestrator
        from dct_tpu_torch.evaluation.gates import GateRejection

        self._counter += 1
        pkg = os.path.join(self.packages_dir, f"pkg-{self._counter:05d}")
        info = package_checkpoint(
            ckpt, pkg,
            processed_dir=self.processed_dir,
        )
        orch = RolloutOrchestrator(
            self.client, self.endpoint,
            soak_seconds=self.soak_s, gate=self._gate(),
        )
        t0 = time.time()
        try:
            orch.run(pkg)
        except GateRejection as rej:
            rec = {
                "ts": time.time(),
                "package": pkg,
                "checkpoint": os.path.basename(ckpt),
                "decision": rej.decision.decision,
                "stage": rej.decision.stage,
                "reason": rej.decision.reason,
            }
            self.held.append(rec)
            self._prune_packages()
            return None
        now = time.time()
        arrival = info.get("data_arrival_ts")
        rec = {
            "ts": now,
            "package": pkg,
            "checkpoint": os.path.basename(ckpt),
            "generation": info.get("data_generation"),
            "freshness_s": (
                round(now - arrival, 4) if arrival else None
            ),
            "rollout_s": round(now - t0, 4),
            "val_loss": info.get("val_loss"),
        }
        self.promotions.append(rec)
        self._prune_packages()
        return rec

    def _prune_packages(self) -> None:
        """Bound disk: drop challenger dirs that no endpoint slot
        references, keeping the newest ``KEEP_PACKAGES`` regardless
        (a just-held package may still be under operator triage)."""
        try:
            dirs = sorted(glob.glob(os.path.join(self.packages_dir, "pkg-*")))
        except OSError:
            return
        live = set()
        resolver = getattr(self.client, "deployment_package_dir", None)
        if resolver is not None:
            try:
                for slot in self.client.list_deployments(self.endpoint):
                    p = resolver(self.endpoint, slot)
                    if p:
                        live.add(os.path.abspath(p))
            except Exception:  # noqa: BLE001 — pruning is hygiene, never fatal
                return
        for d in dirs[:-KEEP_PACKAGES]:
            if os.path.abspath(d) in live:
                continue
            shutil.rmtree(d, ignore_errors=True)

    def run(self, stop_event) -> None:
        """Thread body: poll until ``stop_event`` is set. The pass in
        flight when the stop lands completes (a half-run rollout would
        leave traffic mid-flip); the loop's drain joins this thread."""
        while not stop_event.is_set():
            self.check_once()
            stop_event.wait(self.poll_s)
