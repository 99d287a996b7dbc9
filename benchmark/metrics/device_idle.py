"""Percent of the traced window in which the device ran nothing."""
from benchmark.harness import readers


def read(ctx):
    return readers.device_idle(ctx)
