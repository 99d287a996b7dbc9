"""Device operations per training batch in the traced epochs."""
from benchmark.harness import readers


def read(ctx):
    return readers.device_ops_per_batch(ctx)
