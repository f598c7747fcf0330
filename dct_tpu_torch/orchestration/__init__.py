"""Airflow compatibility (counterpart of ``dct_tpu/orchestration``)."""
