"""Checkpoints: the deploy tier (flax msgpack files) and the resume tier."""
