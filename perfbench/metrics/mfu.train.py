"""The products the configuration's shapes imply for the images of the traced steps of a training cell, over their device window, as a share of the dense bf16 peak, %."""

from perfbench.harness import readers


def read(r):
    return readers.mfu(r)
