"""Image post-processing.  Port of
``stablediffusion_tpu/utils/images.py:124-131`` (``postprocess_image``,
``to_uint8``)."""

from __future__ import annotations

import numpy as np


def postprocess_image(images: np.ndarray) -> np.ndarray:
    """[-1, 1] NHWC -> [0, 1] float32."""
    return np.clip(np.asarray(images, np.float32) / 2.0 + 0.5, 0.0, 1.0)


def to_uint8(images: np.ndarray) -> np.ndarray:
    return (postprocess_image(images) * 255).round().astype(np.uint8)
