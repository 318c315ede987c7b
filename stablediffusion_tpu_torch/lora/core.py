"""LoRA runtime: factor trees, delta-W fusion, train-time injection.

Port of ``stablediffusion_tpu/lora/core.py``.  A LoRA is a dict
{module path: {"down", "up"[, "alpha"]}} over the paths of linear modules,
with the JAX package's layouts: down [in, r], up [r, out], so that a tree
carries across one to one (``io/from_jax.lora_from_jax``).  The port's
linear weights are PyTorch's (out, in), so a fused weight is
(W.float() + (alpha / r) * (down @ up)^T).to(W.dtype), as JAX fuses
W + (alpha / r) * down @ up in its (in, out) layout (``core.py:159-170``).

Fusion is functional: :func:`fuse` and :func:`apply_lora_for_training`
return {"<path>.weight": fused weight} for the touched modules, which
``torch.func.functional_call`` substitutes into the frozen module for one
call.  The base modules stay untouched and ``requires_grad_(False)``; in
training the gradients flow to the factors only.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

# module paths targeted by the reference's trainer: UNet attention
# projections, CLIP attention projections
UNET_TARGET_SUFFIXES = ("to_q", "to_k", "to_v", "to_out.0")
TEXT_TARGET_SUFFIXES = ("q_proj", "k_proj", "v_proj", "out_proj")


def linear_module_paths(module: nn.Module, suffixes: Sequence[str]) -> List[str]:
    """Sorted paths of the submodules with a 2-D ``weight`` parameter (the
    linears) whose path ends with one of `suffixes`."""
    found = []
    for path, m in module.named_modules():
        w = m._parameters.get("weight")
        if w is not None and w.dim() == 2 and any(path.endswith(s) for s in suffixes):
            found.append(path)
    return sorted(found)


def init_lora(
    module: nn.Module,
    rank: int,
    suffixes: Sequence[str],
    generator: torch.Generator,
    store_alpha: bool = True,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fresh fp32 factors on `generator`'s device: down gaussian / rank, up
    zeros (the peft convention), alpha = rank (the reference's setting).
    Pass store_alpha=False for training, so that the scalar is not a
    trainable leaf (a missing alpha means alpha == rank, the same scale)."""
    device = generator.device
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    for path in linear_module_paths(module, suffixes):
        n_out, n_in = module.get_submodule(path).weight.shape
        lora[path] = {
            "down": torch.randn(n_in, rank, generator=generator, device=device) / rank,
            "up": torch.zeros(rank, n_out, device=device),
        }
        if store_alpha:
            lora[path]["alpha"] = torch.tensor(float(rank), device=device)
    return lora


def delta_w(factors: Mapping[str, torch.Tensor],
            scale: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """dW [in, out] = scale * (alpha / r) * down @ up, in fp32."""
    down = factors["down"].float()
    up = factors["up"].float()
    r = down.shape[1]
    alpha = factors.get("alpha")
    a = alpha.float() if alpha is not None else float(r)
    return (a / r) * (down @ up) * scale


def _fused(weight: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """weight (out, in) plus dW given in the JAX layout (in, out)."""
    return (weight.float() + dw.t()).to(weight.dtype)


def fuse(
    module: nn.Module,
    adapters: Mapping[str, Mapping[str, Mapping[str, torch.Tensor]]],
    weights: Optional[Mapping[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """Fused weights {"<path>.weight": W'} of one or more adapters
    {name: lora} at per-adapter scales `weights` (default 1), without
    touching `module`.  An adapter that matches no module raises; paths the
    module lacks are skipped with a warning."""
    weights = weights or {}
    touched: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for name, tree in adapters.items():
            scale = float(weights.get(name, 1.0))
            if scale == 0.0:
                continue
            missing: List[str] = []
            applied = 0
            for path, factors in tree.items():
                try:
                    mod = module.get_submodule(path)
                except AttributeError:
                    missing.append(path)
                    continue
                key = f"{path}.weight"
                w = touched.get(key, mod.weight)
                touched[key] = _fused(w, delta_w(factors, scale).to(w.device))
                applied += 1
            if tree and applied == 0:
                raise ValueError(
                    f"LoRA adapter {name!r} matched no module in the model "
                    f"(unresolved paths, e.g. {missing[:3]})"
                )
            if missing:
                warnings.warn(
                    f"LoRA adapter {name!r}: {len(missing)}/{len(tree)} module "
                    f"paths not present in the model (e.g. {missing[:3]}); "
                    "those factors were skipped"
                )
    return touched


def apply_lora_for_training(
    module: nn.Module, lora: Mapping[str, Mapping[str, torch.Tensor]],
) -> Dict[str, torch.Tensor]:
    """Differentiable fused weights {"<path>.weight": W + dW} for
    ``torch.func.functional_call(module, fused, args)``: the base weights are
    constants, gradients flow to the factors through :func:`delta_w`."""
    return {
        f"{path}.weight": _fused(module.get_submodule(path).weight, delta_w(f))
        for path, f in lora.items()
    }


def num_lora_params(lora: Mapping[str, Mapping[str, torch.Tensor]]) -> int:
    return sum(v.numel() for f in lora.values() for k, v in f.items()
               if k in ("down", "up"))
