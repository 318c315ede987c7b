"""The device trace of a traced run, reduced to what the per-layer readers
take: kernel intervals by name, the busy union, idle gaps, and device time
by kernel group.

``kernel_group`` is a frozen copy of ``chip_smoke.py``'s ``_kernel_group``
(the repository's kernel-name grouping as of the benchmark's first version),
kept here so that a change to the program cannot regroup the yardstick."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def kernel_group(name: str) -> str:
    low = name.lower()
    for key in ("flash_fwd", "flash_stream", "flash_bwd_dkv", "flash_bwd_dq"):
        if key in low:
            return key
    if any(s in low for s in ("conv", "fprop", "dgrad", "implicit", "cudnn")):
        return "convolution"
    # nvjet: cuBLAS's Hopper GEMM kernels; RowwiseMoments: group norm's
    # statistics pass
    if any(s in low for s in ("gemm", "cublas", "cutlass", "xmma", "nvjet")):
        return "gemm"
    if "norm" in low or "moments" in low:
        return "normalization"
    return "elementwise and other"


@dataclass
class DeviceTrace:
    """Kernels (name, start_s, end_s) and host ranges (name, start_s, end_s)
    inside a window [0, window_s] of the run's clock."""
    window_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    ranges: List[Tuple[str, float, float]] = field(default_factory=list)

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def group_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            g = kernel_group(name)
            out[g] = out.get(g, 0.0) + (e - s)
        return out

    def matching(self, names: Tuple[str, ...]) -> List[Tuple[str, float, float]]:
        """The operations whose name contains one of `names`."""
        return [k for k in self.kernels if any(n in k[0].lower() for n in names)]

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations, each named by the
        host range it fell in or, where the trace holds none (host events
        are not traced), by the operations on either side of it."""
        gaps, end, prev = [], 0.0, "window start"
        for name, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if s > end:
                gaps.append((end, s, prev, name))
            if e > end:
                end, prev = e, name
        if self.window_s > end:
            gaps.append((end, self.window_s, prev, "window end"))
        out = []
        for s, e, before, after in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) / 2
            names = [r[0] for r in self.ranges if r[1] <= mid <= r[2]]
            label = names[-1] if names else f"after {_short(before)}, before {_short(after)}"
            out.append([label, e - s])
        return out


def _short(name: str) -> str:
    """A kernel's name without its template arguments, at most 60 letters."""
    name = name.replace("void ", "").split("<")[0].split("(")[0]
    return name[:60]


def capture_start():
    """Start tracing the device (kernels and memory copies only: host
    events of a whole merged call take tens of seconds to read back)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def reduce(prof) -> DeviceTrace:
    """The stopped profiler's device operations (kernels, copies) and
    annotated ranges, in seconds from the first operation's start; the
    window runs from there to the last operation's end (the traced calls
    begin and end with the device drained)."""
    from torch.autograd import DeviceType

    ops, ranges = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        item = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        (ranges if getattr(e, "is_user_annotation", False) else ops).append(item)
    if not ops:
        return DeviceTrace(0.0)
    t0 = min(s for _, s, _ in ops)
    shift = lambda xs: [(n, s - t0, e - t0) for n, s, e in xs]  # noqa: E731
    return DeviceTrace(max(e for _, _, e in ops) - t0, shift(ops), shift(ranges))
