"""Training images consumed by the window's completed steps over the window,
data loading included (host clock; the window ends when the device has
finished its last step)."""

from perfbench.harness import stats


def read(r):
    t0, t_end = r.window
    return stats.rate(r.images, t0, t_end)
