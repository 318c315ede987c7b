"""Images returned without error over the window, from its start to the last
reply: all the work over all the time, the drain included (host clock)."""

from perfbench.harness import stats


def read(r):
    t0, t_last = r.window
    return stats.rate(r.images, t0, t_last)
