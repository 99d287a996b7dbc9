"""Frontier ids the hop caps dropped per training batch in the window."""
from benchmark.harness import readers


def read(ctx):
    return readers.truncated_ids_per_batch(ctx)
