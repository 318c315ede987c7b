"""Safetensors codec.

The port's own copy of ``stablediffusion_tpu/io/safetensors_io.py``: an
8-byte little-endian header length, a JSON header mapping tensor names to
{dtype, shape, data_offsets}, then raw contiguous little-endian bytes.
Tensors read as numpy arrays (``tensor``) or as torch tensors over the
mmap without a copy (``torch_tensor``).  bfloat16 and the fp8 types go
through torch: numpy knows them only through ``ml_dtypes``, which this
package does not need.  ``save_safetensors`` takes numpy arrays and torch
tensors, bf16 included.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

_STR_TO_NUMPY: Dict[str, np.dtype] = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U64": np.dtype("<u8"),
    "U32": np.dtype("<u4"),
    "U16": np.dtype("<u2"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("bool"),
}
_NUMPY_TO_STR = {v: k for k, v in _STR_TO_NUMPY.items()}

_STR_TO_TORCH: Dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_TO_STR = {v: k for k, v in _STR_TO_TORCH.items()}

_MAX_HEADER = 100 * 1024 * 1024  # sanity bound on header size

Array = Union[np.ndarray, torch.Tensor]


class SafetensorsFile:
    """Lazy, mmap-backed reader.

    >>> with SafetensorsFile(path) as f:
    ...     names = f.keys()
    ...     w = f.torch_tensor("conv_in.weight")
    """

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        self._file = open(self.path, "rb")
        try:
            head = self._file.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: truncated safetensors header")
            (header_len,) = struct.unpack("<Q", head)
            if header_len > _MAX_HEADER:
                raise ValueError(f"{self.path}: header length {header_len} too large")
            header = json.loads(self._file.read(header_len))
        except Exception:
            self._file.close()
            raise
        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self._entries: Dict[str, dict] = header
        self._data_start = 8 + header_len
        # copy-on-write pages: torch.frombuffer wants a writable buffer; the
        # file itself is never written
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)

    # -- container protocol -------------------------------------------------
    def keys(self):
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def dtype_str(self, name: str) -> str:
        return self._entries[name]["dtype"]

    def _span(self, name: str, itemsize: int) -> Tuple[int, int, Tuple[int, ...]]:
        e = self._entries[name]
        start, end = e["data_offsets"]
        shape = tuple(e["shape"])
        n = int(np.prod(shape)) if shape else 1
        if end - start != n * itemsize:
            raise ValueError(
                f"{self.path}:{name}: offsets span {end - start} bytes, "
                f"expected {n * itemsize}"
            )
        return self._data_start + start, n, shape

    def tensor(self, name: str) -> np.ndarray:
        """Zero-copy read-only numpy view into the mmap; bf16 and fp8
        tensors raise (read them with ``torch_tensor``)."""
        code = self.dtype_str(name)
        if code not in _STR_TO_NUMPY:
            raise TypeError(f"{self.path}:{name}: {code} has no numpy dtype; "
                            "use torch_tensor")
        dt = _STR_TO_NUMPY[code]
        offset, n, shape = self._span(name, dt.itemsize)
        arr = np.frombuffer(self._mm, dtype=dt, count=n, offset=offset).reshape(shape)
        arr.flags.writeable = False
        return arr

    def torch_tensor(self, name: str) -> torch.Tensor:
        """Zero-copy CPU tensor over the mmap.  It lives no longer than the
        file: copy it (``.to(device)``, ``param.copy_``) before ``close``."""
        dt = _STR_TO_TORCH[self.dtype_str(name)]
        offset, n, shape = self._span(name, torch.empty((), dtype=dt).element_size())
        if n == 0:
            return torch.empty(shape, dtype=dt)
        return torch.frombuffer(self._mm, dtype=dt, count=n, offset=offset).reshape(shape)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.tensor(name)

    def close(self):
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _code_and_size(name: str, arr: Array) -> Tuple[str, int]:
    """(dtype code, byte count) of one numpy array or tensor, without
    copying it."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype not in _TORCH_TO_STR:
            raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
        return _TORCH_TO_STR[arr.dtype], arr.numel() * arr.element_size()
    key = np.dtype(arr.dtype).newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
    if np.dtype(key) not in _NUMPY_TO_STR:
        raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
    return _NUMPY_TO_STR[np.dtype(key)], arr.nbytes


def _bytes(arr: Array) -> bytes:
    """Contiguous little-endian bytes of one numpy array or tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a.tobytes()


def save_safetensors(
    tensors: Mapping[str, Array],
    path: Union[str, os.PathLike],
    metadata: Optional[Mapping[str, str]] = None,
) -> None:
    """Write a safetensors file (sorted keys, contiguous little-endian data),
    one tensor at a time."""
    entries = {}
    offset = 0
    names = sorted(tensors.keys())
    for name in names:
        code, nbytes = _code_and_size(name, tensors[name])
        entries[name] = {
            "dtype": code,
            "shape": list(tensors[name].shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes

    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    header.update(entries)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # pad header to 8-byte alignment with spaces (matches upstream behavior)
    blob += b" " * ((8 - (len(blob) + 8) % 8) % 8)

    tmp = f"{os.fspath(path)}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for name in names:
            fh.write(_bytes(tensors[name]))
    os.replace(tmp, path)
