"""1 - device-busy / wall over the traced train phases."""

from perfbench import readers


def read(ctx):
    return readers.idle(ctx)
