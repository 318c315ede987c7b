"""Seeded weights of a configuration: one state dict per component under the
diffusers key names, drawn on the device by a ``torch.Generator`` in one
call per component, in the dtype the component is served in.

Each matrix or kernel is normal with standard deviation fan_in ** -0.5, so
that activations keep their scale through the network and the denoiser's
prediction is of the order of the noise; embedding tables 0.02; norm scales
1 and biases normal at 0.02.  The same seed gives the same tensors on the
same device, so the reference regenerates them after the program is freed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference import shapes as shape_specs

SPECS = {"unet": shape_specs.unet, "vae": shape_specs.vae,
         "text_encoder": shape_specs.clip_text, "text_encoder_2": shape_specs.clip_text}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def component_seed(seed: int, component: str) -> int:
    site = sorted(SPECS).index(component)
    return int(np.random.SeedSequence([int(seed) % 2**63, 1000 + site]).generate_state(1, np.uint64)[0])


def _std(name: str, shape: Tuple[int, ...]) -> float:
    if len(shape) == 1:
        return 0.02
    if name.endswith("embedding.weight"):
        return 0.02
    return 1.0 / math.sqrt(math.prod(shape[1:]))


@torch.no_grad()
def make_state(config: dict, component: str, seed: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """The component's state dict: views of one buffer drawn in `dtype`."""
    shapes = SPECS[component](config)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(component_seed(seed, component))
    buf = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = buf[at:at + n].view(shape)
        at += n
        if len(shape) == 1 and not name.endswith(".bias"):
            t.fill_(1.0)
        else:
            t.mul_(_std(name, shape))
        out[name] = t
    return out


def make_weights(spec: dict, seed: int, device, dtype_override=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{component: state dict} of a configuration file's ``components``, each
    in its ``served_dtypes`` entry, cast to `dtype_override` after the draw
    when given (the reference's float32 copy of the same values)."""
    out = {}
    for comp, cfg in spec["components"].items():
        if comp not in SPECS:
            continue
        sd = make_state(cfg, comp, seed, DTYPES[spec["served_dtypes"][comp]], device)
        if dtype_override is not None:
            sd = {k: v.to(dtype_override) for k, v in sd.items()}
        out[comp] = sd
    return out
