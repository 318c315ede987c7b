"""Profiler spans and training metrics.

Port of ``stablediffusion_tpu/utils/observability.py``:

  * :func:`trace` (``trace`` :25-38): a ``torch.profiler.record_function``
    span (visible in a trace that :func:`profile_to` or any
    ``torch.profiler.profile`` records; outside one it costs a no-op
    range) plus the wall clock, observed as ``{name}_sec`` in `metrics`.
    The wall is the host's: the card runs asynchronously, so a span around
    work that ends without a synchronize measures its launch.  The
    trainers wrap each step in "train_step", the handler each pipeline
    call in "generate" (JAX calls neither; its spans are the profiler's
    own).
  * :func:`profile_to` (``profile_to`` :41-52): a ``torch.profiler``
    trace of the block, the CPU and (on the card) CUDA activity, exported
    as a Chrome trace ``{logdir}/trace.json`` (Perfetto and
    chrome://tracing read it).
  * :class:`Metrics` (:55-90): the last value and the count of each named
    scalar, validation images, and a TensorBoard writer
    (``torch.utils.tensorboard.SummaryWriter``) when that imports;
    otherwise the values stay in memory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(name: str, metrics: Optional["Metrics"] = None):
    """Annotate a region for the profiler and record its wall time."""
    import torch

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if metrics is not None:
        metrics.observe(name + "_sec", time.perf_counter() - t0)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Trace the block with ``torch.profiler`` and write the Chrome trace
    ``{logdir}/trace.json``; yields the profiler (``key_averages()``)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Metrics:
    """Last values and counts of named scalars; an optional TensorBoard sink."""

    def __init__(self, tensorboard_dir: Optional[str] = None):
        self.values: Dict[str, float] = {}
        self.counts: Dict[str, int] = defaultdict(int)
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                logger.info("tensorboard unavailable; metrics stay in memory")

    def observe(self, name: str, value: float, step: Optional[int] = None):
        self.values[name] = float(value)
        self.counts[name] += 1
        if self._tb is not None:
            self._tb.add_scalar(name, value, step if step is not None else self.counts[name])

    def images(self, tag: str, images, step: int = 0):
        """`images` [B, H, W, C] in [0, 1]."""
        if self._tb is not None:
            self._tb.add_images(tag, np.asarray(images), step, dataformats="NHWC")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
            self._tb = None
