"""p95 of the program's training batch times (its ``train.batch`` spans)."""
from benchmark.harness import program_trace


def read(ctx):
    return program_trace.step_ms_p95(ctx)
