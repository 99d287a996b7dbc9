"""The untraced window's model FLOPs as a percent of the card's float32 peak."""
from benchmark.harness import readers


def read(ctx):
    return readers.mfu(ctx)
