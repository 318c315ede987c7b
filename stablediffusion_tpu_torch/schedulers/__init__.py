"""Scheduler registry.  Port of ``stablediffusion_tpu/schedulers/__init__.py``
(``make_scheduler``), DDIM only in this slice."""

from __future__ import annotations

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import Plan
from stablediffusion_tpu_torch.schedulers.ddim import DDIMScheduler

SCHEDULER_REGISTRY = {"DDIM": DDIMScheduler}

# the JAX package's other names, each ported with slice 2 of the port
_LATER = (
    "euler", "euler_a", "DPM++ 2M", "DPM++ 2M Karras", "DPM++ 2M SDE Karras",
    "DPM++ 3M SDE", "DPM++ 3M SDE Karras", "PNDM", "uni_pc", "heun", "lms",
    "DDPM", "LCM", "FlowMatchEuler",
)


def make_scheduler(name: str, config: SchedulerConfig = SchedulerConfig()):
    if name in SCHEDULER_REGISTRY:
        return SCHEDULER_REGISTRY[name](config)
    if name in _LATER:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet: it comes with slice 2 "
            "(the rest of SD1.5/SDXL inference); this slice has DDIM"
        )
    raise ValueError(f"unknown scheduler {name!r}; available: {sorted(SCHEDULER_REGISTRY)}")


__all__ = ["DDIMScheduler", "Plan", "SCHEDULER_REGISTRY", "make_scheduler"]
