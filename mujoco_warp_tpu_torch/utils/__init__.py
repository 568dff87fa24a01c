"""Utilities: the benchmark harness (`utils.benchmark`)."""
