"""Attention's share of its roofline in the traced merged calls of a serving cell: the implied calls' bounds over the attention kernels' device time, %."""

from perfbench.harness import readers


def read(r):
    return readers.attn_roofline(r)
