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
same build.  The build directory (:data:`BUILD_DIR`) lies inside the
package and is listed in ``.gitignore``, unless ``core/compile_cache``
points it at a persistent cache.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills of every kernel, in BUILD_LOGS
)

# C signature shared by the two forward entries: q, k, v, o, dtype,
# B, H, Sq, Skv, D, 12 strides, scale (then flash_fwd: causal, lse; both:
# stream)
_ATTN_ARGS = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12
    + [ctypes.c_float]
)
# the two backward entries (csrc/flash_bwd.cu): q, k, v, dO, lse, di, dq, dk,
# dv, dtype, B, H, Sq, Skv, D, 21 strides, scale, causal, stream
_BWD_ARGS = (
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 21
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# one shared library per source file
SOURCES = ("flash_fwd", "flash_stream", "flash_bwd")
# kernel name -> (source, C symbol, argtypes)
ENTRIES = {
    "flash_fwd": ("flash_fwd", "sdt_flash_fwd",
                  _ATTN_ARGS + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "flash_stream": ("flash_stream", "sdt_flash_stream", _ATTN_ARGS + [ctypes.c_void_p]),
    "flash_bwd_dq": ("flash_bwd", "sdt_flash_bwd_dq", _BWD_ARGS),
    "flash_bwd_dkv": ("flash_bwd", "sdt_flash_bwd_dkv", _BWD_ARGS),
}

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output of each source this process compiled (ptxas -v included)
BUILD_LOGS: Dict[str, str] = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# flash_stream's widest head dim on its TMA-fed kernel (csrc/flash_stream.cu)
STREAM_TMA_MAX_D = 512


class LaunchCounter:
    """Plain-integer count of a kernel's launches, and the same launches by
    call shape: the wrapper calls :meth:`add` where it launches the kernel and
    nowhere else.  ``by_shape`` maps (q shape, Skv, dtype, causal, lse) to a
    count; ``lse`` marks a forward that also wrote the log-sum-exp for a
    backward."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_shape: Dict[tuple, int] = {}

    def add(self, q: torch.Tensor, k: torch.Tensor, causal: bool = False,
            lse: bool = False) -> None:
        self.count += 1
        key = (tuple(q.shape), k.shape[1], str(q.dtype).replace("torch.", ""),
               bool(causal), bool(lse))
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


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc`` per
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
                    BUILD_LOGS[n] = log
            if failures:
                raise RuntimeError("\n".join(failures))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return paths


def ptxas_usage(log: str) -> List[dict]:
    """Registers and spilled bytes (stores + loads) of each kernel in an
    nvcc log with ``-Xptxas -v``; kernels named like
    ``flash_bwd_dq_wgmma_kernel<48>``, ``flash_stream_kernel<bf16, 512>``,
    ``flash_fwd_wgmma_kernel<48, 64>``, ``flash_bwd_dkv_wgmma_kernel<64, 1>``
    or, not a template, ``flash_stream_ffma_kernel``."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_(?:(?!flash_)\w)*?_kernel)"
                          r"(?:I(\w*?)Li(\d+)E(?:Li(\d+)E)?|E)", m.group(1))
            if k is None:
                name = m.group(1)
            elif k.group(3) is None:
                name = k.group(1)
            else:
                dtype = {"": "", "f": "float, "}.get(k.group(2), "bf16, ")
                name = f"{k.group(1)}<{dtype}{', '.join(i for i in k.groups()[2:] if i)}>"
            spill = 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append({"kernel": name, "registers": int(m.group(1)), "spill_bytes": spill})
    return rows


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed, with the
    argument types of its entries set."""
    lib = _loaded.get(source)
    if lib is None:
        path = build([source])[source]
        lib = ctypes.CDLL(str(path))
        for src, symbol, argtypes in ENTRIES.values():
            if src == source:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel `name`."""
    source, symbol, _ = ENTRIES[name]
    return getattr(load(source), symbol)


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def check_attention_inputs(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    d_min: int, d_max: int,
) -> None:
    """Raise on any q/k/v that a CUDA attention kernel does not take."""
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
        if not vector_loadable(t):
            raise ValueError(
                f"{name}: {tn} must have a contiguous last dim, be 16-byte "
                "aligned and have strides that are multiples of 8 elements "
                "(the kernel's 16-byte vector loads)"
            )


def vector_loadable(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte row loads can read `t` as it lies: last
    dim contiguous, 16-byte aligned, the other strides multiples of 8."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def tma_mappable(t: torch.Tensor) -> bool:
    """Whether the TMA-fed kernels' 4-D tensor map (D, H, S, B) can describe
    `t` beyond what :func:`vector_loadable` asks: each dimension longer
    than 1 steps by a positive stride whose byte size is below 2**40
    (``cuTensorMapEncodeTiled``'s limit; a dimension of size 1 is given the
    dense stride, since it is never stepped)."""
    return all(s > 0 and s * t.element_size() < 2**40
               for s, n in zip(t.stride(), t.shape) if n > 1)


def check_tma_mappable(name: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Raise a ValueError naming the first of `tensors` (name -> tensor)
    that a TMA tensor map cannot read (:func:`tma_mappable`)."""
    for tn, t in tensors.items():
        if not tma_mappable(t):
            raise ValueError(
                f"{name}: {tn} cannot be read through a TMA tensor map: every "
                "dimension longer than 1 needs a positive stride below 2**39 "
                "elements"
            )


def strides3(t: torch.Tensor) -> List[int]:
    """(batch, sequence, head) strides of a [B, S, H, D] tensor."""
    return [t.stride(0), t.stride(1), t.stride(2)]


def attention_launch_args(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    d_min: int, d_max: int,
) -> Tuple[torch.Tensor, List]:
    """Check what a CUDA attention forward takes, allocate its output, and
    return (out, ctypes arguments up to and excluding the scale).  Raises on
    anything the kernel does not take."""
    check_attention_inputs(name, q, k, v, d_min, d_max)
    # the TMA-fed kernels: every flash_fwd one, and flash_stream's at D <= 512
    if name == "flash_fwd" or q.shape[-1] <= STREAM_TMA_MAX_D:
        check_tma_mappable(name, {"q": q, "k": k, "v": v})
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    args = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)]
    args += [_DTYPE_CODES[q.dtype], B, H, Sq, k.shape[1], D]
    for t in (q, k, v, out):
        args += strides3(t)
    return out, args


def bwd_launch_args(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, di: torch.Tensor, dq: Optional[torch.Tensor],
    dk: Optional[torch.Tensor], dv: Optional[torch.Tensor],
) -> List:
    """The backward entries' ctypes arguments up to and excluding the scale.
    q/k/v/dO are checked as the forward checks q/k/v (and that a TMA map
    can read each, :func:`check_tma_mappable`); lse and di must be
    contiguous fp32 [B, H, Sq]; an output that is None is not written by the
    entry called (its pointer is null)."""
    check_attention_inputs("flash_bwd", q, k, v, 8, 160)
    B, Sq, H, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_bwd: dO {tuple(do.shape)} {do.dtype} does not match q")
    if not vector_loadable(do):
        raise ValueError("flash_bwd: dO is not laid out for 16-byte row loads")
    check_tma_mappable("flash_bwd", {"q": q, "k": k, "v": v, "dO": do})
    for t, tn in ((lse, "lse"), (di, "di")):
        if (t.shape != (B, H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash_bwd: {tn} must be contiguous fp32 [B, H, Sq] on q's device")
    outs = [(dq, q), (dk, k), (dv, v)]
    for t, like in outs:
        if t is not None and (t.shape != like.shape or t.dtype != like.dtype
                              or t.stride(-1) != 1):
            raise ValueError("flash_bwd: a gradient output does not match its input")
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    args = [ptr(t) for t in (q, k, v, do, lse, di, dq, dk, dv)]
    args += [_DTYPE_CODES[q.dtype], B, H, Sq, k.shape[1], D]
    for t in (q, k, v, do):
        args += strides3(t)
    for t, like in outs:
        args += strides3(t if t is not None else like)
    return args
