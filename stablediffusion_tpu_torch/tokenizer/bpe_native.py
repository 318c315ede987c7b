"""ctypes bridge to the C++ BPE merge loop (``csrc/bpe.cpp``).

Port of ``stablediffusion_tpu/tokenizer/bpe_native.py``.  The library is
compiled with ``g++`` on first use into the kernels' build directory
(``ops/_build.BUILD_DIR``: the git-ignored ``_kernels_build/``, or the
persistent cache of ``core/compile_cache``), never beside its source as
JAX's is; its file name carries a hash of the source and flags, so an
edited source rebuilds.  When it cannot be built or loaded, ``available()``
is False and ``tokenizer/clip_bpe.CLIPTokenizer`` keeps its pure-Python
merge loop, as JAX's does; ``clip_bpe.TOKENIZE_PATHS`` counts the words
each path tokenized.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent.parent / "csrc" / "bpe.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIB_CACHE: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def lib_path() -> Path:
    from stablediffusion_tpu_torch.ops import _build

    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return Path(_build.BUILD_DIR) / f"bpe-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing (a file lock keeps concurrent
    processes from racing); returns its path."""
    out = lib_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                               capture_output=True)
                os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB_CACHE, _LIB_FAILED
    if _LIB_CACHE is not None or _LIB_FAILED:
        return _LIB_CACHE
    try:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bpe_new_table.restype = ctypes.c_void_p
        lib.bpe_new_table.argtypes = [i32p, i32p, i32p, ctypes.c_int32]
        lib.bpe_free_table.argtypes = [ctypes.c_void_p]
        lib.bpe_encode_word.restype = ctypes.c_int32
        lib.bpe_encode_word.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32, i32p,
                                        ctypes.c_int32]
        _LIB_CACHE = lib
    except Exception as e:  # no toolchain: the pure-Python loop stays
        logger.info("native BPE unavailable (%s); using pure Python", e)
        _LIB_FAILED = True
    return _LIB_CACHE


class NativeBPE:
    """Vocab-id-space BPE: every symbol (single char, char</w>, merged token)
    is addressed by its vocab id, so the C loop emits final token ids."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native BPE library unavailable")
        self._lib = lib
        i32p = ctypes.POINTER(ctypes.c_int32)
        left = np.asarray([vocab[a] for a, b in merges], np.int32)
        right = np.asarray([vocab[b] for a, b in merges], np.int32)
        merged = np.asarray([vocab[a + b] for a, b in merges], np.int32)
        self._table = ctypes.c_void_p(lib.bpe_new_table(
            left.ctypes.data_as(i32p), right.ctypes.data_as(i32p),
            merged.ctypes.data_as(i32p), len(merges)))
        self._buf = np.empty(4096, np.int32)

    def __del__(self):
        try:
            if getattr(self, "_table", None):
                self._lib.bpe_free_table(self._table)
        except Exception:
            pass

    def encode_word(self, sym_ids: List[int]) -> List[int]:
        i32p = ctypes.POINTER(ctypes.c_int32)
        arr = np.asarray(sym_ids, np.int32)
        n = self._lib.bpe_encode_word(self._table, arr.ctypes.data_as(i32p), len(arr),
                                      self._buf.ctypes.data_as(i32p), len(self._buf))
        if n < 0:
            raise RuntimeError("BPE output buffer overflow")
        return self._buf[:n].tolist()


def available() -> bool:
    return _load_lib() is not None
