"""Always-on overlapped cycles (counterpart of ``dct_tpu/continuous``):
the ingest watcher, the training pump and the promotion evaluator as
concurrent actors over atomically published artifacts, and the serial
episodic cycle built from the same primitives."""
