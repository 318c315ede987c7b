"""Heun discrete sampler (k-diffusion's second-order sample_heun, churn 0).

Port of ``stablediffusion_tpu/schedulers/heun.py``.  Heun needs two model
evaluations per sampler step, so the plan interleaves the grid: timesteps
[t0, t1, t1, t2, t2, ...] (2N-1 entries) and sigmas
[s0, s1, s1, ..., s_{N-1}, s_{N-1}, 0].  Even indices are the Euler
predictor, odd ones the trapezoidal corrector; the final step (even, to
sigma 0) stays first order.  ``Plan.order == 2`` makes img2img's strength
and ``denoising_start`` slices land on pair boundaries.  The state is the
predictor's derivative and the sample it started from.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.schedulers.common import Plan
from stablediffusion_tpu_torch.schedulers.euler import EulerDiscreteScheduler

_TINY = np.float32(1e-10)


class HeunDiscreteScheduler(EulerDiscreteScheduler):
    order = 2  # two plan indices per sampler step

    def plan(self, num_steps: int, timesteps: Optional[np.ndarray] = None,
             sigmas: Optional[np.ndarray] = None) -> Plan:
        base = super().plan(num_steps, timesteps=timesteps, sigmas=sigmas)
        ts, sg = base.timesteps, base.sigmas
        ts2 = np.concatenate([ts[:1], np.repeat(ts[1:], 2)]).astype(np.float32)
        sg2 = np.concatenate([sg[:1], np.repeat(sg[1:-1], 2), sg[-1:]]).astype(np.float32)
        return Plan(
            timesteps=ts2,
            sigmas=sg2,
            alphas_cumprod=base.alphas_cumprod,
            init_noise_sigma=base.init_noise_sigma,
            final_alpha_cumprod=base.final_alpha_cumprod,
            num_steps=len(ts2),
            order=2,
        )

    def init_state(self, plan: Plan, sample_shape, device=None) -> tuple:
        z = torch.zeros(sample_shape, device=device)
        return (z, z)  # the predictor's derivative and starting sample

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        prev_deriv, saved_sample = state
        s = plan.sigmas
        first = i % 2 == 0  # predictor at even indices
        sigma = s[i] if first else s[max(i - 1, 0)]
        sigma_next = s[i + 1] if first else s[i]
        # the corrector's `sample` is the Euler-predicted latent at
        # sigma_next, so its x0 and derivative use sigma_next
        sigma_input = sigma if first else sigma_next

        sample32 = sample.float()
        x0 = self._pred_x0(model_output.float(), sample32, sigma_input)
        deriv = (sample32 - x0) / np.maximum(sigma_input, _TINY)
        dt = sigma_next - sigma
        if first:
            return (sample32 + deriv * dt).to(sample.dtype), (deriv, sample32)
        prev = saved_sample + np.float32(0.5) * (prev_deriv + deriv) * dt
        z = torch.zeros_like(sample32)
        return prev.to(sample.dtype), (z, z)
