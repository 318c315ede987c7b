"""Share of the device window of the traced steps of a training cell in which no operation ran, %."""

from perfbench.harness import readers


def read(r):
    return readers.idle_share(r)
