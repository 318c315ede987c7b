"""Persistent build cache of the CUDA kernels.

Port of ``stablediffusion_tpu/core/compile_cache.py``.  The port has no
jit: its cold start is ``nvcc`` building the three kernel libraries
(``ops/_build.py``) and ``g++`` the native BPE loop
(``tokenizer/bpe_native.py``).  :func:`enable_compilation_cache` points
their build directory at ``$SDTPU_COMPILE_CACHE/cuda`` (default
``~/.cache/sdtpu-cuda``), so a worker or trainer started from a fresh
checkout reuses the libraries an earlier one built.  A library's file name
carries a hash of its sources and flags, so a stale build is never loaded.
When nothing calls it, the build directory stays the package's git-ignored
``_kernels_build/``.  The serving worker and the three training CLIs call
it, as JAX's do; like JAX's, which skips every backend but the TPU, it
does nothing without a card unless it is given a `path`.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_ENABLED: Optional[Path] = None


def cache_dir(path: Optional[str] = None) -> Path:
    root = path or os.environ.get("SDTPU_COMPILE_CACHE",
                                  os.path.join(os.path.expanduser("~"), ".cache", "sdtpu-cuda"))
    return Path(root) / "cuda"


def enable_compilation_cache(path: Optional[str] = None) -> bool:
    """Build and load the kernels under :func:`cache_dir` (`path` in place of
    the environment's root).  Returns True once enabled; False where the
    directory cannot be made, which leaves the in-package default."""
    global _ENABLED
    import torch

    from stablediffusion_tpu_torch.ops import _build

    if path is None and not torch.cuda.is_available():
        logger.info("kernel build cache skipped without a card")
        return False
    target = cache_dir(path)
    if _ENABLED == target:
        return True
    try:
        target.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        logger.warning("kernel build cache unavailable (%s); building in %s", e,
                       _build.BUILD_DIR)
        return False
    _build.BUILD_DIR = target
    _ENABLED = target
    logger.info("kernel build cache at %s", target)
    return True
