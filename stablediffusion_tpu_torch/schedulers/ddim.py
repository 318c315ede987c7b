"""DDIM (Song et al. 2020), deterministic eta = 0.

Port of ``stablediffusion_tpu/schedulers/ddim.py:24-80`` (``plan`` and
``step``).  The step runs in fp32 and casts back to the sample's dtype; the
per-step scalars are taken from the fp32 alpha table in fp32, as the JAX
step computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import (
    Plan,
    make_alphas_cumprod,
    make_timestep_grid,
    prediction_to_x0_eps,
)


class DDIMScheduler:
    order = 1

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self._alphas_cumprod_np = make_alphas_cumprod(config)
        self.alphas_cumprod = self._alphas_cumprod_np.astype(np.float32)

    def plan(self, num_steps: int) -> Plan:
        timesteps = make_timestep_grid(self.config, num_steps)
        final_alpha = (
            1.0 if self.config.set_alpha_to_one else float(self._alphas_cumprod_np[0])
        )
        return Plan(
            timesteps=timesteps,
            sigmas=np.zeros((len(timesteps) + 1,), np.float32),
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=1.0,
            final_alpha_cumprod=float(np.float32(final_alpha)),
            num_steps=len(timesteps),
            step_ratio=self.config.num_train_timesteps // num_steps,
        )

    def scale_model_input(self, plan: Plan, sample: torch.Tensor, i: int):
        return sample

    def step(self, plan: Plan, i: int, model_output: torch.Tensor,
             sample: torch.Tensor) -> torch.Tensor:
        """x_{t-1} from x_t and the model output at step index i."""
        t = int(plan.timesteps[i])
        prev_t = t - plan.step_ratio
        f32 = np.float32
        ac_t = f32(plan.alphas_cumprod[t])
        ac_prev = (
            f32(plan.alphas_cumprod[prev_t]) if prev_t >= 0
            else f32(plan.final_alpha_cumprod)
        )
        alpha_t = float(np.sqrt(ac_t))
        sigma_t = float(np.sqrt(f32(1.0) - ac_t))

        sample32 = sample.float()
        x0, eps = prediction_to_x0_eps(
            self.config.prediction_type, model_output.float(), sample32,
            alpha_t, sigma_t,
        )
        if self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
            eps = (sample32 - alpha_t * x0) / sigma_t
        # eta = 0: x_{t-1} = sqrt(ac_prev) x0 + sqrt(1 - ac_prev) eps
        prev = float(np.sqrt(ac_prev)) * x0 + float(np.sqrt(f32(1.0) - ac_prev)) * eps
        return prev.to(sample.dtype)
