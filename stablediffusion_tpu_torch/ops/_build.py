"""Build and load the package's CUDA kernels (no counterpart in the JAX
package, whose kernels Pallas compiles inside jit).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, on first use, and loaded with ``ctypes``:
pointers and the stream pass as ``c_void_p``, sizes as ``c_int``, strides as
``c_longlong``.  Every C entry returns the launch's ``cudaGetLastError()``;
:func:`check` raises when it is not 0.  :func:`attention_launch_args`
checks what the attention kernels take and lays out their C arguments.

The library's file name carries a hash of its sources and flags, so an edited
source rebuilds.  A file lock keeps concurrent processes from racing on the
same build.  The build directory lies inside the package and is listed in
``.gitignore``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# C signature shared by the two attention entries: q, k, v, o, dtype,
# B, H, Sq, Skv, D, 12 strides, scale[, causal], stream
_ATTN_ARGS = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12
    + [ctypes.c_float]
)
SIGNATURES = {
    "flash_fwd": ("sdt_flash_fwd", _ATTN_ARGS + [ctypes.c_int, ctypes.c_void_p]),
    "flash_stream": ("sdt_flash_stream", _ATTN_ARGS + [ctypes.c_void_p]),
}

_loaded: Dict[str, ctypes.CDLL] = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Plain-integer count of a kernel's launches, and the same launches by
    call shape: the wrapper calls :meth:`add` where it launches the kernel and
    nowhere else.  ``by_shape`` maps (q shape, Skv, dtype, causal) to a count."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_shape: Dict[tuple, int] = {}

    def add(self, q: torch.Tensor, k: torch.Tensor, causal: bool = False) -> None:
        self.count += 1
        key = (tuple(q.shape), k.shape[1], str(q.dtype).replace("torch.", ""), bool(causal))
        self.by_shape[key] = self.by_shape.get(key, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_shape = {}

    def __repr__(self) -> str:
        return f"LaunchCounter({self.name!r}, count={self.count})"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source on first use"
        )
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str, out: Path) -> subprocess.Popen:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together; returns name -> library path."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            for n in names:
                if not paths[n].exists():
                    tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
                    procs[n] = (_start_build(n, tmp), tmp)
            failures = []
            for n, (proc, tmp) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"nvcc failed for {n}.cu:\n{log}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, paths[n])
            if failures:
                raise RuntimeError("\n".join(failures))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel `name`."""
    return getattr(load(name), SIGNATURES[name][0])


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def attention_launch_args(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    d_min: int, d_max: int,
) -> Tuple[torch.Tensor, List]:
    """Check what a CUDA attention kernel takes, allocate its output, and
    return (out, ctypes arguments up to and excluding the scale).  Raises on
    anything the kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name}: takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name}: wants q [B,Sq,H,D], k/v [B,Skv,H,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not (d_min <= D <= d_max and D % 8 == 0):
        raise ValueError(f"{name}: head dim {D} outside ({d_min - 1}, {d_max}] or not a multiple of 8")
    if B * H > 65535 or Sq == 0 or Skv == 0:
        raise ValueError(f"{name}: B*H={B * H}, Sq={Sq}, Skv={Skv} out of range")
    for t, tn in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tn}'s last dim must be contiguous")
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: {tn} must be 16-byte aligned with strides that are "
                "multiples of 8 elements (the kernel's 16-byte vector loads)"
            )
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    args = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)]
    args += [_DTYPE_CODES[q.dtype], B, H, Sq, Skv, D]
    for t in (q, k, v, out):
        args += [t.stride(0), t.stride(1), t.stride(2)]
    return out, args
