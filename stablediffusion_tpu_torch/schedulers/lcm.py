"""LCM scheduler (Latent Consistency Models, Luo et al. 2023).

Port of ``stablediffusion_tpu/schedulers/lcm.py``: timesteps subsampled
from the 50-step origin grid, the consistency boundary scalings (sigma_data
0.5, timestep scaling 10), and ancestral re-noising between steps (fresh
noise each step, none after the last).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    _need_noise,
    prediction_to_x0_eps,
    reject_custom_sigmas,
)

ORIGIN_STEPS = 50
SIGMA_DATA = 0.5
TIMESTEP_SCALING = 10.0
f32 = np.float32


class LCMScheduler(BaseScheduler):
    order = 1

    def uses_noise(self) -> bool:
        return True

    def plan(self, num_steps: int, timesteps: Optional[np.ndarray] = None,
             sigmas: Optional[np.ndarray] = None) -> Plan:
        reject_custom_sigmas(self, sigmas)
        T = self.config.num_train_timesteps
        if timesteps is None:
            if num_steps > ORIGIN_STEPS:
                raise ValueError(f"LCM supports at most {ORIGIN_STEPS} steps, got {num_steps}")
            c = T // ORIGIN_STEPS
            origin = np.arange(1, ORIGIN_STEPS + 1) * c - 1  # ascending
            # floor-linspace indices into the descending origin grid
            idx = np.floor(np.linspace(0, len(origin), num_steps, endpoint=False)).astype(np.int64)
            timesteps = origin[::-1][idx]
        timesteps = np.ascontiguousarray(timesteps, np.int64)
        return Plan(
            timesteps=timesteps,
            sigmas=np.zeros((len(timesteps) + 1,), np.float32),
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=1.0,
            final_alpha_cumprod=1.0,
            num_steps=len(timesteps),
            step_ratio=T // ORIGIN_STEPS,
        )

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        noise = _need_noise(self, noise)
        t = int(plan.timesteps[i])
        ac_t = f32(plan.alphas_cumprod[t])
        ac_prev = f32(plan.alphas_cumprod[int(plan.timesteps[min(i + 1, plan.num_steps - 1)])])
        sample32 = sample.float()
        x0, _ = prediction_to_x0_eps(
            self.config.prediction_type, model_output.float(), sample32,
            np.sqrt(ac_t), np.sqrt(f32(1.0) - ac_t),
        )
        # consistency boundary conditions at scaled timestep t * 10
        st = f32(t) * f32(TIMESTEP_SCALING)
        c_skip = f32(SIGMA_DATA**2) / (st**2 + f32(SIGMA_DATA**2))
        c_out = st / np.sqrt(st**2 + f32(SIGMA_DATA**2))
        denoised = c_out * x0 + c_skip * sample32
        if i < plan.num_steps - 1:
            denoised = np.sqrt(ac_prev) * denoised + np.sqrt(f32(1.0) - ac_prev) * noise
        return denoised.to(sample.dtype), state
