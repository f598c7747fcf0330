"""Parallelism (the dtype rules in this slice; mesh and sharding are later)."""
