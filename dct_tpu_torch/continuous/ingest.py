"""The ingest watcher: the continuous loop's data-arrival edge
(counterpart of ``IngestWatcher`` in ``dct_tpu/continuous/ingest.py``).

:class:`IngestWatcher` (``DCT_INGEST_MODE=poll``, the default) polls the
staging CSV on a cadence (a cheap ``stat`` pre-check, so an idle loop costs
two syscalls a poll) and hands any change to the incremental ETL
(:func:`dct_tpu_torch.etl.preprocess.preprocess_csv_to_parquet`), which
digests the content and decides no-op / append-only delta / full rebuild.
ETL runs concurrently with training: by the time the trainer's next round
starts, the fresh generation is published. The stream mode (the
partitioned event log and its exactly-once ETL, the reference's
``StreamIngestWatcher``) is ROADMAP Queue A item 24, and the reference's
``ingest.*`` events are item 27: :attr:`IngestWatcher.log` keeps their
fields.
"""

from __future__ import annotations

import os
import time


class IngestWatcher:
    """Polls ``raw_csv`` and feeds the incremental ETL.

    Single-consumer by design: one watcher owns the processed dir's
    etl_state. ``check_once`` is the unit (poll loops and tests share
    it); :meth:`run` is the thread body.
    """

    def __init__(
        self,
        raw_csv: str,
        processed_dir: str,
        *,
        poll_s: float = 2.0,
    ):
        self.raw_csv = raw_csv
        self.processed_dir = processed_dir
        self.poll_s = float(poll_s)
        self._last_stat: tuple | None = None
        self._retries = 0
        self.processed = 0
        self.errors = 0
        #: processed generations and errors, in order (the fields of the
        #: reference's ingest.processed / ingest.error events)
        self.log: list[dict] = []

    def _stat(self) -> tuple | None:
        try:
            st = os.stat(self.raw_csv)
        except OSError:
            return None
        return (st.st_size, st.st_mtime_ns)

    def check_once(self) -> dict | None:
        """One poll: stat pre-check, then the incremental ETL on any
        change. Returns the published etl_state when a generation was
        processed, None otherwise (no data / unchanged / ETL no-op)."""
        cur = self._stat()
        if cur is None or cur == self._last_stat:
            return None
        from dct_tpu_torch.etl.preprocess import (
            preprocess_csv_to_parquet,
            read_etl_state,
        )

        before = read_etl_state(self.processed_dir).get("generation", 0)
        t0 = time.time()
        try:
            preprocess_csv_to_parquet(
                self.raw_csv, self.processed_dir, incremental=True
            )
        except Exception as e:  # noqa: BLE001 — the loop must outlive one bad poll
            self.errors += 1
            # Transient failures (disk pressure mid-publish, a reader
            # race) retry on the next polls; only a persistent failure
            # parks this content's stat — a permanently-broken file
            # must not re-parse every poll, while any FIX changes the
            # stat (mtime_ns at minimum) and is picked up.
            self._retries += 1
            parked = self._retries >= 3
            if parked:
                self._last_stat = cur
                self._retries = 0
            self.log.append({
                "event": "ingest.error", "parked": parked,
                "error": f"{type(e).__name__}: {e}"[:300],
            })
            return None
        self._last_stat = cur
        self._retries = 0
        state = read_etl_state(self.processed_dir)
        if state.get("generation", 0) == before:
            return None  # content digest said no-op (mtime-only touch)
        self.processed += 1
        self.log.append({
            "event": "ingest.processed",
            "generation": state.get("generation"),
            "mode": state.get("mode"),
            "rows": state.get("rows"),
            "rows_delta": state.get("rows_delta"),
            "etl_s": round(time.time() - t0, 4),
            "arrival_ts": state.get("arrival_ts"),
        })
        return state

    def run(self, stop_event) -> None:
        """Thread body: poll until ``stop_event`` is set."""
        while not stop_event.is_set():
            self.check_once()
            stop_event.wait(self.poll_s)
