"""Training metrics.

Port of the ``Metrics`` class of ``stablediffusion_tpu/utils/observability.py``
(:55-90), the part the trainer uses: the last value and the count of each
named scalar, validation images, and a TensorBoard writer
(``torch.utils.tensorboard.SummaryWriter``) when that imports; otherwise
the values stay in memory.  The module's profiler spans are ROADMAP §1
item 21.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


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
