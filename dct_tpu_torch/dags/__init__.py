"""The port's Airflow DAG files (counterparts of ``dags/``): the reference's
``dag_id``s, task ids, edges and trigger targets, with commands that run the
port's entry points (``python3 -m dct_tpu_torch.<job>``). Point Airflow's
DAG folder here; without Airflow they build on
:mod:`dct_tpu_torch.orchestration.compat`."""
