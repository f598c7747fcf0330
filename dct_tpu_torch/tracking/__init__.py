"""Experiment tracking: the file store, an import-gated MLflow client."""
