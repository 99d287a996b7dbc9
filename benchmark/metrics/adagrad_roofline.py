"""The row-sparse Adagrad kernel's traced launches as a percent of their roofline."""
from benchmark.harness import readers


def read(ctx):
    return readers.roofline(ctx, "adagrad")
