"""Share of the device window of the traced merged calls of a serving cell in which no operation ran, %."""

from perfbench.harness import readers


def read(r):
    return readers.idle_share(r)
