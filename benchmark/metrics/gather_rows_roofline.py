"""The gather_rows kernel's traced launches as a percent of their roofline."""
from benchmark.harness import readers


def read(ctx):
    return readers.roofline(ctx, "gather_rows")
