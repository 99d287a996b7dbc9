"""Host self time of the neighbour sampler (``sample`` spans) per training batch."""
from benchmark.harness import program_trace


def read(ctx):
    return program_trace.sampler_ms_per_batch(ctx)
