"""The 90th percentile of submit-to-reply seconds over every request of the
window; a failed request counts as missing any limit (host clock)."""

from perfbench.harness import stats


def read(r):
    return stats.percentile(stats.latencies(r.log), 90)
