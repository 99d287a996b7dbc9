"""The device allocator's peak over the window, in GiB."""
from benchmark.harness import readers


def read(ctx):
    return readers.peak_device_gib(ctx)
