"""Training-state checkpoints: save, rotate, resume.

Port of ``stablediffusion_tpu/train/checkpoint.py`` (:1-83): the same
``checkpoint-{N}`` directories under the output dir, ``total_limit``
rotation, and the "latest" | path resume contract.  The JAX package writes
its state with orbax; the port writes no orbax.  A state is a nested tree of
dicts, ``QuantizedMoment``s (the 8-bit Adam moments: int8/uint8 codes and
fp32 scales) and leaves; each tensor leaf goes into ``state.safetensors``
(``io/safetensors_io.py``) under its "/"-joined path, each other leaf (an
int such as ``count`` or ``mini_step``, a float, None) into
``state.json``.  A port checkpoint is therefore not orbax-readable, nor the
reverse.  ``load_checkpoint`` rebuilds a tree of its template's structure,
each tensor on its template tensor's device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile, save_safetensors
from stablediffusion_tpu_torch.train.optim import QuantizedMoment

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
TENSORS = "state.safetensors"
SCALARS = "state.json"


def flatten_state(tree: Any, prefix: str = "") -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """({path: tensor}, {path: other leaf}) of a state tree."""
    tensors: Dict[str, torch.Tensor] = {}
    scalars: Dict[str, Any] = {}
    if isinstance(tree, QuantizedMoment):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            t, s = flatten_state(v, f"{prefix}{k}/")
            tensors.update(t)
            scalars.update(s)
    elif isinstance(tree, torch.Tensor):
        tensors[prefix[:-1]] = tree
    else:
        scalars[prefix[:-1]] = tree
    return tensors, scalars


def _rebuild(template: Any, tensors: Mapping[str, torch.Tensor], scalars: Mapping[str, Any],
             prefix: str = "") -> Any:
    if isinstance(template, QuantizedMoment):
        return QuantizedMoment(**_rebuild(template._asdict(), tensors, scalars, prefix))
    if isinstance(template, Mapping):
        return {k: _rebuild(v, tensors, scalars, f"{prefix}{k}/") for k, v in template.items()}
    path = prefix[:-1]
    if isinstance(template, torch.Tensor):
        t = tensors[path]
        if t.dtype != template.dtype or tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint tensor {path}: {t.dtype} {tuple(t.shape)} where "
                             f"the state holds {template.dtype} {tuple(template.shape)}")
        t = t.to(template.device)
        t.__dict__.update(template.__dict__)  # an FSDP slice's tags (parallel/zero.py)
        return t
    return scalars[path]


def save_checkpoint(output_dir: str, step: int, state: Any,
                    total_limit: Optional[int] = None) -> str:
    """Write checkpoint-{step} and rotate old ones, keeping at most
    `total_limit` with the new one."""
    os.makedirs(output_dir, exist_ok=True)
    if total_limit is not None:
        existing = sorted((int(m.group(1)), d) for d in os.listdir(output_dir)
                          if (m := _CKPT_RE.match(d)))
        while len(existing) >= total_limit:
            _, oldest = existing.pop(0)
            shutil.rmtree(os.path.join(output_dir, oldest), ignore_errors=True)
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    os.makedirs(path, exist_ok=True)
    tensors, scalars = flatten_state(state)
    save_safetensors(tensors, os.path.join(path, TENSORS))
    with open(os.path.join(path, SCALARS), "w") as f:
        json.dump({"step": step, "scalars": scalars}, f, indent=1, sort_keys=True)
    return path


def latest_checkpoint(output_dir: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the newest checkpoint-{N}, or None."""
    if not os.path.isdir(output_dir):
        return None
    found = sorted((int(m.group(1)), d) for d in os.listdir(output_dir)
                   if (m := _CKPT_RE.match(d)))
    if not found:
        return None
    step, d = found[-1]
    return step, os.path.abspath(os.path.join(output_dir, d))


def load_checkpoint(path: str, template: Any) -> Any:
    """The state saved at `path`, in `template`'s structure and devices."""
    with open(os.path.join(path, SCALARS)) as f:
        scalars = json.load(f)["scalars"]
    with SafetensorsFile(os.path.join(path, TENSORS)) as f:
        tensors = {k: f.torch_tensor(k).clone() for k in f.keys()}
    return _rebuild(template, tensors, scalars)


def resolve_resume(arg: Optional[str], output_dir: str) -> Optional[Tuple[int, str]]:
    """'latest' -> the newest checkpoint-{N} under output_dir; an explicit
    .../checkpoint-{N} path -> (N, path); else None."""
    if not arg:
        return None
    if arg == "latest":
        return latest_checkpoint(output_dir)
    m = re.search(r"checkpoint-(\d+)$", arg)
    return (int(m.group(1)), arg) if m else None
