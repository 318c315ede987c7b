"""Carry weights from the JAX package's param trees into the port's modules.

The inverse of ``stablediffusion_tpu/io/torch_convert.py:90-98``
(``deconvert_tensor``): the JAX package keeps conv kernels HWIO and linear
kernels (in, out); the port's modules keep PyTorch's OIHW and (out, in).
Embedding tables keep their (vocab, dim) layout, by the same exact-suffix
rule (:28-36), so that ``time_embedding.linear_1`` is still transposed.

A tree is nested dicts of numpy arrays (``jax.device_get`` of a param tree
gives one), so this module imports nothing of JAX.  Loading is strict: a key
the module lacks, or a module parameter the tree lacks, raises.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

_EMBEDDING_TABLE_RE = re.compile(
    r"(^|\.)(token_embedding|position_embedding|class_embedding|shared"
    r"|embed_tokens|relative_attention_bias)"
    r"\.weight$"
)


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """tree['a']['b']['c'] -> {'a.b.c': array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def to_torch_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW for conv kernels, (in, out) -> (out, in) for linear
    kernels; embedding tables and every non-weight unchanged."""
    if not key.endswith(".weight"):
        return arr
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2 and _EMBEDDING_TABLE_RE.search(key) is None:
        return np.transpose(arr)
    return arr


def load_from_jax(
    module: nn.Module, tree: Mapping, skip_prefixes: Iterable[str] = ()
) -> nn.Module:
    """Copy a JAX-layout param tree into `module` (in place, keeping each
    parameter's device and dtype).  Keys under `skip_prefixes` (parts of the
    tree that the module does not port, such as the VAE encoder) are left
    out; any other mismatch raises."""
    skip = tuple(skip_prefixes)
    flat = {k: v for k, v in flatten(tree).items() if not k.startswith(skip)}
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise KeyError(
            f"param tree does not match {type(module).__name__}: "
            f"missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
            f"unexpected {unexpected[:8]}{'...' if len(unexpected) > 8 else ''}"
        )
    with torch.no_grad():
        for key, arr in flat.items():
            dst = state[key]
            if arr.dtype.kind not in "fiub":  # e.g. ml_dtypes' bfloat16
                arr = arr.astype(np.float32)
            src = torch.from_numpy(np.array(to_torch_layout(key, arr), order="C"))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{key}: tree shape {tuple(src.shape)} (torch layout) != "
                    f"module shape {tuple(dst.shape)}"
                )
            dst.copy_(src.to(dst.dtype))
    return module
