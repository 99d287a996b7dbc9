"""Host synchronisations inside the program's epochs per training batch."""
from benchmark.harness import program_trace


def read(ctx):
    return program_trace.host_syncs_per_batch(ctx)
