"""Scheduler registry.  Port of ``stablediffusion_tpu/schedulers/__init__.py``:
the 15 serving names, each a class and its config overrides over a shared
``SchedulerConfig``, and ``make_scheduler``."""

from __future__ import annotations

import dataclasses

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import BaseScheduler, Plan
from stablediffusion_tpu_torch.schedulers.ddim import DDIMScheduler
from stablediffusion_tpu_torch.schedulers.ddpm import DDPMScheduler
from stablediffusion_tpu_torch.schedulers.dpm import DPMSolverMultistepScheduler
from stablediffusion_tpu_torch.schedulers.euler import (
    EulerAncestralScheduler,
    EulerDiscreteScheduler,
)
from stablediffusion_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
from stablediffusion_tpu_torch.schedulers.heun import HeunDiscreteScheduler
from stablediffusion_tpu_torch.schedulers.lcm import LCMScheduler
from stablediffusion_tpu_torch.schedulers.lms import LMSDiscreteScheduler
from stablediffusion_tpu_torch.schedulers.pndm import PNDMScheduler
from stablediffusion_tpu_torch.schedulers.unipc import UniPCScheduler

# name -> (class, config overrides), in the JAX registry's order
SCHEDULER_REGISTRY = {
    "DDIM": (DDIMScheduler, {}),
    "euler": (EulerDiscreteScheduler, {}),
    "euler_a": (EulerAncestralScheduler, {}),
    "DPM++ 2M": (DPMSolverMultistepScheduler, {"algorithm_type": "dpmsolver++"}),
    "DPM++ 2M Karras": (
        DPMSolverMultistepScheduler,
        {"algorithm_type": "dpmsolver++", "use_karras_sigmas": True},
    ),
    "DPM++ 2M SDE Karras": (
        DPMSolverMultistepScheduler,
        {"algorithm_type": "sde-dpmsolver++", "use_karras_sigmas": True},
    ),
    "DPM++ 3M SDE": (
        DPMSolverMultistepScheduler,
        {"algorithm_type": "sde-dpmsolver++", "solver_order": 3},
    ),
    "DPM++ 3M SDE Karras": (
        DPMSolverMultistepScheduler,
        {"algorithm_type": "sde-dpmsolver++", "solver_order": 3,
         "use_karras_sigmas": True},
    ),
    "PNDM": (PNDMScheduler, {}),
    "uni_pc": (UniPCScheduler, {}),
    "heun": (HeunDiscreteScheduler, {}),
    "lms": (LMSDiscreteScheduler, {}),
    "DDPM": (DDPMScheduler, {}),
    "LCM": (LCMScheduler, {}),
    "FlowMatchEuler": (FlowMatchEulerScheduler, {}),
}

SCHEDULER_NAMES = tuple(SCHEDULER_REGISTRY.keys())


def make_scheduler(name: str, config: SchedulerConfig = SchedulerConfig()) -> BaseScheduler:
    """A scheduler by its serving name over a shared base config."""
    if name not in SCHEDULER_REGISTRY:
        raise ValueError(f"unknown scheduler {name!r}; available: {sorted(SCHEDULER_REGISTRY)}")
    cls, overrides = SCHEDULER_REGISTRY[name]
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return cls(config)


__all__ = [
    "BaseScheduler", "Plan", "SchedulerConfig", "DDIMScheduler", "DDPMScheduler",
    "DPMSolverMultistepScheduler", "EulerAncestralScheduler", "EulerDiscreteScheduler",
    "FlowMatchEulerScheduler", "HeunDiscreteScheduler", "LCMScheduler",
    "LMSDiscreteScheduler", "PNDMScheduler", "UniPCScheduler",
    "SCHEDULER_REGISTRY", "SCHEDULER_NAMES", "make_scheduler",
]
