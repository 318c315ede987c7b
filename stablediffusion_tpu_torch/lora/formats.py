"""LoRA files: diffusers/peft and kohya-ss safetensors.

Port of ``stablediffusion_tpu/lora/formats.py`` onto the port's
``io/safetensors_io.py``.  Keys read:

  * peft/diffusers:   ``unet.<path>.lora_A.weight`` [r, in] /
                      ``.lora_B.weight`` [out, r] (``.alpha`` optional)
  * legacy diffusers: ``unet.<path>.lora.down.weight`` / ``.lora.up.weight``
                      (attention-processor paths are mapped back)
  * kohya-ss:         ``lora_unet_<path_with_underscores>.lora_down.weight``,
                      ``.lora_up.weight``, ``.alpha``, with ``lora_te_`` /
                      ``lora_te1_`` / ``lora_te2_`` for the text towers

The parsed form is {component: {module path: {"down" [in, r], "up" [r,
out][, "alpha"]}}} of CPU tensors in the file's dtype, the layouts of
``lora/core.py`` and of the JAX package's trees.  Files are written with
torch layouts in either naming (``save_lora_file``), so the two packages
read each other's files.

A factor that is not a matrix is refused: kohya's SD1.x files carry the 1x1
convolutions ``proj_in`` / ``proj_out`` as [r, in, 1, 1] factors, which the
JAX package transposes to a 4-D tree that fuses to a misshapen weight.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile, save_safetensors

COMPONENTS = ("unet", "transformer", "text_encoder", "text_encoder_2")
_KOHYA_PREFIXES = {
    "lora_transformer_": "transformer",
    "lora_unet_": "unet",
    "lora_te1_": "text_encoder",
    "lora_te2_": "text_encoder_2",
    "lora_te_": "text_encoder",
}
_KOHYA_SAVE_PREFIX = {"unet": "lora_unet_", "transformer": "lora_transformer_"}


def validate_lora_keys(keys: Iterable[str]) -> None:
    """Every key must name a LoRA factor or an alpha."""
    bad = [k for k in keys if "lora" not in k and not k.endswith(".alpha")]
    if bad:
        raise ValueError(f"not a LoRA state dict; offending keys: {bad[:5]}")


def _kohya_fallback_path(flat_path: str) -> str:
    """Undo kohya's '.' -> '_' around numeric segments, for a path the
    model's table does not resolve."""
    path = re.sub(r"_(\d+)_", r".\1.", flat_path)
    path = re.sub(r"_(\d+)$", r".\1", path)
    return path.replace("transformer.blocks", "transformer_blocks")


def _factor(component: str, path: str, kind: str, value: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{"alpha"} as a 0-d fp32 tensor, {"down"} / {"up"} transposed to the
    [in, r] / [r, out] layouts; any factor that is not 2-D raises."""
    if kind == "alpha":
        return {"alpha": torch.tensor(float(value.reshape(-1)[0]))}
    if value.dim() != 2:
        raise ValueError(
            f"LoRA factor {component}.{path} ({kind}) has shape {tuple(value.shape)}: "
            f"only 2-D (linear) factors are supported; {value.dim()}-D factors such as "
            "kohya's 1x1-conv proj_in/proj_out are refused")
    name = "down" if kind in ("lora_down.weight", "lora_A.weight", "lora.down.weight") else "up"
    return {name: value.t().contiguous()}


def parse_lora_state_dict(
    flat: Mapping[str, torch.Tensor],
    model_paths: Optional[Mapping[str, Iterable[str]]] = None,
) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Flat tensors -> {component: {module path: {down, up[, alpha]}}}.
    `model_paths` ({component: module paths}, ``SDModel.lora_module_paths``)
    resolves kohya's underscore-flattened names."""
    validate_lora_keys(flat.keys())
    out: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {c: {} for c in COMPONENTS}
    resolvers = {c: {p.replace(".", "_"): p for p in model_paths[c]}
                 for c in COMPONENTS if model_paths and c in model_paths}
    for key, value in flat.items():
        value = torch.as_tensor(value)
        prefix = next((p for p in _KOHYA_PREFIXES if key.startswith(p)), None)
        if prefix is not None:  # kohya
            component = _KOHYA_PREFIXES[prefix]
            m = re.match(r"(.+?)\.(lora_down\.weight|lora_up\.weight|alpha)$",
                         key[len(prefix):])
            if not m:
                raise ValueError(f"unrecognized kohya key {key!r}")
            flat_path, kind = m.groups()
            path = resolvers.get(component, {}).get(flat_path) or _kohya_fallback_path(flat_path)
        else:  # diffusers / peft
            component = next((c for c in ("text_encoder_2", "text_encoder", "unet",
                                          "transformer") if key.startswith(c + ".")), None)
            if component is None:
                raise ValueError(f"unrecognized LoRA key {key!r}")
            m = re.match(r"(.+?)\.(lora_A\.weight|lora_B\.weight|lora\.down\.weight|"
                         r"lora\.up\.weight|alpha)$", key[len(component) + 1:])
            if not m:
                raise ValueError(f"unrecognized LoRA key {key!r}")
            path, kind = m.groups()
            # legacy attention-processor paths
            path = path.replace(".processor", "")
            path = re.sub(r"\.to_out_lora$", ".to_out.0", path)
            path = re.sub(r"\.(to_[qkv])_lora$", r".\1", path)
        out[component].setdefault(path, {}).update(_factor(component, path, kind, value))
    for c, tree in out.items():
        for path, e in tree.items():
            if "down" not in e or "up" not in e:
                raise ValueError(f"incomplete LoRA pair at {c}.{path}")
    return {c: v for c, v in out.items() if v}


def load_lora_file(
    path: str, model_paths: Optional[Mapping[str, Iterable[str]]] = None
) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """Parse a LoRA safetensors file; the tensors are copied off the file."""
    with SafetensorsFile(path) as f:
        flat = {k: f.torch_tensor(k).clone() for k in f.keys()}
    return parse_lora_state_dict(flat, model_paths)


def save_lora_file(
    adapters: Mapping[str, Mapping[str, Mapping[str, torch.Tensor]]],
    path: str,
    metadata: Optional[Mapping[str, str]] = None,
    format: str = "peft",
) -> None:
    """Write {component: {module path: factors}} as fp32 safetensors in
    torch layouts.  format="peft": ``{component}.{path}.lora_A/B.weight``
    plus ``.alpha`` where it differs from the rank.  format="kohya":
    ``lora_unet_{path_with_underscores}.lora_down/up.weight`` and an
    ``.alpha`` for every module; the text towers as ``lora_te1_`` /
    ``lora_te2_`` when a second-tower adapter is present, else
    ``lora_te_``.  Both read back through :func:`parse_lora_state_dict`."""
    def as_np(x) -> np.ndarray:
        return np.asarray(torch.as_tensor(x).detach().float().cpu().numpy())

    flat: Dict[str, np.ndarray] = {}
    if format == "kohya":
        has_te2 = "text_encoder_2" in adapters
        for component, tree in adapters.items():
            prefix = _KOHYA_SAVE_PREFIX.get(component) or {
                "text_encoder": "lora_te1_" if has_te2 else "lora_te_",
                "text_encoder_2": "lora_te2_",
            }[component]
            for mpath, factors in tree.items():
                down, up = as_np(factors["down"]).T, as_np(factors["up"]).T
                key = prefix + mpath.replace(".", "_")
                flat[f"{key}.lora_down.weight"] = down
                flat[f"{key}.lora_up.weight"] = up
                alpha = factors.get("alpha")
                flat[f"{key}.alpha"] = np.asarray(
                    float(alpha) if alpha is not None else float(down.shape[0]), np.float32)
    elif format == "peft":
        for component, tree in adapters.items():
            for mpath, factors in tree.items():
                down, up = as_np(factors["down"]).T, as_np(factors["up"]).T
                flat[f"{component}.{mpath}.lora_A.weight"] = down
                flat[f"{component}.{mpath}.lora_B.weight"] = up
                alpha = factors.get("alpha")
                if alpha is not None and float(alpha) != down.shape[0]:
                    flat[f"{component}.{mpath}.alpha"] = np.asarray(float(alpha), np.float32)
    else:
        raise ValueError(f"unknown LoRA save format {format!r}")
    save_safetensors(flat, path, metadata=metadata or {"format": "pt"})
