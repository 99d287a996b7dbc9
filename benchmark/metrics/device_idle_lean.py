"""Percent of a cycle profiled for device activity alone in which the device ran nothing."""
from benchmark.harness import program_trace


def read(ctx):
    return program_trace.device_idle_lean(ctx)
