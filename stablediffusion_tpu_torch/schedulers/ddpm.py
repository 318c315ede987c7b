"""DDPM (Ho et al. 2020): the training-side scheduler.

Port of ``stablediffusion_tpu/schedulers/ddpm.py``.  Training uses its
forward diffusion (``add_noise``, ``get_velocity`` on
:class:`~stablediffusion_tpu_torch.schedulers.common.BaseScheduler`); the
ancestral ``step`` is here for completeness.  The step runs in fp32 with the
per-step scalars taken from the fp32 table in fp32, as the JAX step computes
them, and takes its noise injected or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    make_betas,
    make_timestep_grid,
    prediction_to_x0_eps,
)


class DDPMScheduler(BaseScheduler):
    order = 1

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        super().__init__(config)
        self.betas = make_betas(config).astype(np.float32)

    def plan(self, num_steps: int) -> Plan:
        timesteps = make_timestep_grid(self.config, num_steps)
        return Plan(
            timesteps=timesteps,
            sigmas=np.zeros((len(timesteps) + 1,), np.float32),
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=1.0,
            final_alpha_cumprod=1.0,
            num_steps=len(timesteps),
            step_ratio=self.config.num_train_timesteps // num_steps,
        )

    def step(self, plan: Plan, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x_{t-1} from x_t: the posterior mean plus sqrt(variance) * noise,
        with `noise` given or drawn from `generator` (standard normal, the
        sample's shape)."""
        t = int(plan.timesteps[i])
        prev_t = t - (plan.step_ratio or self.config.num_train_timesteps // plan.num_steps)
        f32 = np.float32
        ac_t = f32(plan.alphas_cumprod[t])
        ac_prev = f32(plan.alphas_cumprod[prev_t]) if prev_t >= 0 else f32(1.0)
        current_alpha = ac_t / ac_prev
        current_beta = f32(1.0) - current_alpha

        sample32 = sample.float()
        x0, _ = prediction_to_x0_eps(
            self.config.prediction_type, model_output.float(), sample32,
            float(np.sqrt(ac_t)), float(np.sqrt(f32(1.0) - ac_t)),
        )
        if self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        x0_coeff = np.sqrt(ac_prev) * current_beta / (f32(1.0) - ac_t)
        cur_coeff = np.sqrt(current_alpha) * (f32(1.0) - ac_prev) / (f32(1.0) - ac_t)
        mean = float(x0_coeff) * x0 + float(cur_coeff) * sample32
        variance = max((f32(1.0) - ac_prev) / (f32(1.0) - ac_t) * current_beta, f32(1e-20))
        if noise is None:
            if generator is None:
                raise ValueError("DDPM step needs injected noise or a generator")
            noise = torch.randn(sample32.shape, generator=generator, device=sample.device)
        std = float(np.sqrt(variance)) if t > 0 else 0.0
        return (mean + std * noise.float()).to(sample.dtype)
