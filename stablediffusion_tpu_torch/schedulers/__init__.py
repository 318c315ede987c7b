"""Scheduler registry.  Port of ``stablediffusion_tpu/schedulers/__init__.py``
(``make_scheduler``): DDIM for inference and DDPM, the training scheduler."""

from __future__ import annotations

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import BaseScheduler, Plan
from stablediffusion_tpu_torch.schedulers.ddim import DDIMScheduler
from stablediffusion_tpu_torch.schedulers.ddpm import DDPMScheduler

SCHEDULER_REGISTRY = {"DDIM": DDIMScheduler, "DDPM": DDPMScheduler}

# the JAX package's other names, each ported with slice 2 of the port
_LATER = (
    "euler", "euler_a", "DPM++ 2M", "DPM++ 2M Karras", "DPM++ 2M SDE Karras",
    "DPM++ 3M SDE", "DPM++ 3M SDE Karras", "PNDM", "uni_pc", "heun", "lms",
    "LCM", "FlowMatchEuler",
)


def make_scheduler(name: str, config: SchedulerConfig = SchedulerConfig()):
    if name in SCHEDULER_REGISTRY:
        return SCHEDULER_REGISTRY[name](config)
    if name in _LATER:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet: it comes with slice 2 "
            "(the rest of SD1.5/SDXL inference); the port has DDIM and DDPM"
        )
    raise ValueError(f"unknown scheduler {name!r}; available: {sorted(SCHEDULER_REGISTRY)}")


__all__ = ["BaseScheduler", "DDIMScheduler", "DDPMScheduler", "Plan",
           "SCHEDULER_REGISTRY", "make_scheduler"]
