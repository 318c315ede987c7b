"""Flow-matching Euler scheduler (rectified flow; diffusers
FlowMatchEulerDiscreteScheduler semantics).

Port of ``stablediffusion_tpu/schedulers/flow_match.py``: train sigmas
t / T, resolution-shifted sigma' = shift * sigma / (1 + (shift - 1) * sigma);
the model predicts the velocity eps - x0, so the step is
x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v; noising is
(1 - sigma) * x0 + sigma * eps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    broadcast_to_sample,
)


class FlowMatchEulerScheduler(BaseScheduler):
    order = 1

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        T = self.config.num_train_timesteps
        raw = np.arange(T, 0, -1, dtype=np.float64) / T  # 1 .. 1/T descending
        self._train_sigmas = self._shift(raw)
        self.sigma_min = float(self._train_sigmas[-1])
        self.sigma_max = float(self._train_sigmas[0])
        # alphas_cumprod has no meaning under rectified flow; a table of
        # ones keeps the Plan uniform
        self._alphas_cumprod_np = np.ones((T,), np.float64)
        self.alphas_cumprod = np.ones((T,), np.float32)

    def _shift(self, sigmas: np.ndarray) -> np.ndarray:
        s = self.config.shift
        return s * sigmas / (1.0 + (s - 1.0) * sigmas)

    def plan(self, num_steps: int, timesteps: Optional[np.ndarray] = None,
             sigmas: Optional[np.ndarray] = None) -> Plan:
        if timesteps is not None and sigmas is not None:
            raise ValueError("pass only one of `timesteps` or `sigmas`")
        T = self.config.num_train_timesteps
        if sigmas is not None:
            sig = self._shift(np.asarray(sigmas, np.float64))
        elif timesteps is not None:
            sig = self._shift(np.asarray(timesteps, np.float64) / T)
        else:
            ts = np.linspace(T * self.sigma_max, T * self.sigma_min, num_steps)
            sig = self._shift(ts / T)
        ts_out = sig * T
        sig = np.concatenate([sig, [0.0]]).astype(np.float32)
        return Plan(
            timesteps=np.asarray(ts_out, np.float32),
            sigmas=sig,
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=float(sig[0]),
            final_alpha_cumprod=1.0,
            num_steps=len(ts_out),
        )

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        dt = plan.sigmas[i + 1] - plan.sigmas[i]
        return (sample.float() + dt * model_output.float()).to(sample.dtype), state

    def add_noise_index(self, plan: Plan, original, noise, i: int):
        sigma = plan.sigmas[i]
        out = (np.float32(1.0) - sigma) * original.float() + sigma * noise.float()
        return out.to(original.dtype)

    # -- training -----------------------------------------------------------
    def add_noise(self, original, noise, timesteps):
        """`timesteps` are flow timesteps (sigma * T, float)."""
        sigma = broadcast_to_sample(
            torch.as_tensor(timesteps, dtype=torch.float32, device=original.device)
            / self.config.num_train_timesteps, original)
        return ((1.0 - sigma) * original.float() + sigma * noise.float()).to(original.dtype)

    def get_velocity(self, sample, noise, timesteps):
        """The flow-matching target v = eps - x0."""
        return (noise.float() - sample.float()).to(sample.dtype)
