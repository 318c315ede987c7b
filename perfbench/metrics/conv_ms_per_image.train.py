"""Device ms of the convolution kernels (the frozen grouping of harness/trace.py) per image of the traced steps of a training cell."""

from perfbench.harness import readers


def read(r):
    return readers.conv_ms_per_image(r)
