"""Host seconds of one validation evaluation, mean over the window."""
from benchmark.harness import readers


def read(ctx):
    return readers.eval_s(ctx)
