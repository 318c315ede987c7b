"""Seconds from the process's start to the first timed request: weights made
on the card, the kernels loaded (or built), every batch shape warmed."""


def read(r):
    return r.setup_s
