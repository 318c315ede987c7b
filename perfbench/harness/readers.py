"""Readings shared by the per-layer metric files of the serving and training
cells (each file under ``metrics/`` names its quantity and calls one of
these).  Each returns None where the run has nothing for it to read."""

from __future__ import annotations

from perfbench.harness import flops

ATTENTION_OPS = ("flash_fwd", "flash_bwd", "flash_stream")


def _traced(r):
    return r.trace if r.trace is not None and r.trace.window_s > 0 and r.traced_calls else None


def idle_share(r):
    tr = _traced(r)
    return None if tr is None else 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def conv_ms_per_image(r):
    tr = _traced(r)
    images = sum(c["images"] for c in r.traced_calls)
    conv = tr.group_s().get("convolution") if tr is not None else None
    return None if conv is None or not images else 1e3 * conv / images


def mfu(r):
    """Useful work of the traced calls (the products the configuration's
    shapes imply for each completed image; a serving call's padding rows
    not counted) over the traced device window, as a share of the card's
    dense bf16 peak."""
    tr = _traced(r)
    if tr is None:
        return None
    done = sum(c["images"] for c in r.traced_calls) * r.work(1).flops  # linear in the rows
    return 100.0 * done / tr.window_s / flops.peak(r.device_name)


def attn_roofline(r):
    """The sum of the bounds of the attention calls the traced calls imply
    (at each call's rows, padding included, since the kernels compute them)
    over the device time of the operations named like the attention
    kernels; a backward is two such operations.  A count of operations other
    than the calls imply raises: the share would compare different work."""
    tr = _traced(r)
    if tr is None:
        return None
    calls = [a for c in r.traced_calls for a in r.work(c["rows"]).attention]
    ops = tr.matching(ATTENTION_OPS)
    implied = sum(2 if a.backward else 1 for a in calls)
    if len(ops) != implied:
        names = {}
        for n, _, _ in ops:
            names[n[:60]] = names.get(n[:60], 0) + 1
        raise RuntimeError(f"attn_roofline: {len(ops)} attention operations traced, {implied} "
                           f"implied by {len(r.traced_calls)} calls: {names}")
    return 100.0 * flops.attention_bound_s(calls, r.device_name) / sum(e - s for _, s, e in ops)


def peak_mem_gib(r):
    return r.memory_peak_bytes / 2**30 if r.memory_peak_bytes else None
