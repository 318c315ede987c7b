"""The allocator's peak over the window of a training cell (max_memory_allocated after a reset at its start), GiB."""

from perfbench.harness import readers


def read(r):
    return readers.peak_mem_gib(r)
