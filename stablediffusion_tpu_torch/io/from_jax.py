"""Carry weights from the JAX package's param trees into the port's modules.

The inverse of ``stablediffusion_tpu/io/torch_convert.py:90-98``
(``deconvert_tensor``): the JAX package keeps conv kernels HWIO and linear
kernels (in, out); the port's modules keep PyTorch's OIHW and (out, in).
Embedding tables keep their (vocab, dim) layout, by the same exact-suffix
rule (:28-36), so that ``time_embedding.linear_1`` is still transposed.  The
rule covers every tree of the port's modules: CLIP, the UNet and the VAE,
the MM-DiT (its HWIO patch kernel ``pos_embed.proj.weight``, and
``pos_embed.pos_embed``, a [1, positions, dim] table that is no weight and
keeps its layout), T5 (the ``shared`` and ``relative_attention_bias``
tables), the ControlNet (HWIO convolutions, the trunk's UNet keys), the CLIP
vision tower (its HWIO patch kernel; ``class_embedding`` a vector and
``position_embedding`` a table, both as they are) and the IP-Adapter's image
projection (the Resampler's ``latents`` [1, queries, dim], no weight).

An int8 layer of a quantized tree (JAX ``ops/quant.quantize_params``)
carries ``weight_int8`` in the HWIO or (in, out) layout with a ``w8_scale``
or ``w8a8_scale`` of shape [..., out]; both take the weight's permutation, to
the port's [out, ...] layout (``ops/quant.py``).  :func:`to_jax_layout` is
the inverse, for the int8 folders written in JAX's canonical layout.

A tree is nested dicts of numpy arrays (``jax.device_get`` of a param tree
gives one), so this module imports nothing of JAX.  Loading is strict: a key
the module lacks, or a module parameter the tree lacks, raises.  LoRA trees
(:func:`lora_from_jax`) keep their layout: the port's ``lora/core.py`` uses
JAX's down [in, r] / up [r, out].
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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


# the tensors laid out as weights: fp and int8 kernels, and the int8 scales
# (keepdims over the contracted axes, so they permute as their kernel)
_KERNEL_SUFFIXES = (".weight", ".weight_int8", ".w8_scale", ".w8a8_scale")


def _to_torch_perm(key: str, ndim: int):
    """The permutation from JAX's layout to torch's of tensor `key`, or None
    when it keeps its layout."""
    if not key.endswith(_KERNEL_SUFFIXES):
        return None
    if ndim == 4:
        return (3, 2, 0, 1)  # HWIO -> OIHW
    if ndim == 2 and _EMBEDDING_TABLE_RE.search(key) is None:
        return (1, 0)
    return None


def to_torch_layout(key: str, arr):
    """HWIO -> OIHW for conv kernels, (in, out) -> (out, in) for linear
    kernels, int8 kernels and their scales alike; embedding tables and
    every other tensor unchanged.  Takes a numpy array or a tensor."""
    perm = _to_torch_perm(key, arr.ndim)
    if perm is None:
        return arr
    return arr.permute(perm) if isinstance(arr, torch.Tensor) else np.transpose(arr, perm)


def to_jax_layout(key: str, arr):
    """The inverse of :func:`to_torch_layout`: torch's layout -> JAX's."""
    perm = _to_torch_perm(key, arr.ndim)
    if perm is None:
        return arr
    inv = tuple(int(i) for i in np.argsort(perm))
    return arr.permute(inv) if isinstance(arr, torch.Tensor) else np.transpose(arr, inv)


def load_from_jax(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX-layout param tree into `module` (in place, keeping each
    parameter's device and dtype); where the tree holds an int8 layer, its
    int8 form is swapped into `module` first.  Any key mismatch raises."""
    from stablediffusion_tpu_torch.ops.quant import swap_in_int8_layers

    flat = flatten(tree)
    swap_in_int8_layers(module, flat)
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


def lora_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA tree {module path: {"down" [in, r], "up" [r, out][,
    "alpha"]}} of numpy arrays as the port's LoRA, with the same paths and
    layouts (``lora/core.py`` keeps JAX's down/up layout, so nothing is
    transposed), fp32 on the CPU."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, factors in tree.items():
        extra = set(factors) - {"down", "up", "alpha"}
        if not {"down", "up"} <= set(factors) or extra:
            raise KeyError(f"LoRA factors at {path!r} have keys {sorted(factors)}")
        out[path] = {
            name: torch.from_numpy(np.array(arr, dtype=np.float32))
            for name, arr in factors.items()
        }
    return out
