"""PNDM / PLMS (Liu et al. 2022): linear multistep over a 4-deep epsilon
history, with SD's ``skip_prk_steps=True`` convention.

Port of ``stablediffusion_tpu/schedulers/pndm.py``.  The PLMS grid repeats
the second base timestep (a Heun-like warm-up evaluation), so N requested
steps run N+1 UNet evaluations.  The state is the epsilon history (newest
first) and the sample that step 0 started from.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    reject_custom_sigmas,
)

f32 = np.float32

# PLMS weights over the eps history [newest, ..., oldest], rows by history
# depth 2..4
_AB = np.array(
    [
        [3 / 2, -1 / 2, 0, 0],
        [23 / 12, -16 / 12, 5 / 12, 0],
        [55 / 24, -59 / 24, 37 / 24, -9 / 24],
    ],
    dtype=np.float32,
)


class PNDMScheduler(BaseScheduler):
    order = 1

    def plan(self, num_steps: int, timesteps: Optional[np.ndarray] = None,
             sigmas: Optional[np.ndarray] = None) -> Plan:
        reject_custom_sigmas(self, sigmas)
        if timesteps is None:
            ratio = self.config.num_train_timesteps // num_steps
            base = (np.arange(num_steps) * ratio).round().astype(np.int64)
            base += self.config.steps_offset
            # PLMS: repeat the second-to-last, then reverse
            ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        else:
            ts = np.asarray(timesteps)
        return Plan(
            timesteps=np.ascontiguousarray(ts, np.int64),
            sigmas=np.zeros((len(ts) + 1,), np.float32),
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=1.0,
            final_alpha_cumprod=float(np.float32(self._alphas_cumprod_np[0])),
            num_steps=len(ts),
            step_ratio=self.config.num_train_timesteps // num_steps,
        )

    def init_state(self, plan: Plan, sample_shape, device=None) -> tuple:
        # the eps history (newest first, up to 4) and step 0's sample
        return ((), torch.zeros(sample_shape, device=device))

    def _prev_sample(self, plan: Plan, sample, t: int, prev_t: int, eps):
        ac_t = f32(plan.alphas_cumprod[t])
        ac_prev = (f32(plan.alphas_cumprod[prev_t]) if prev_t >= 0
                   else f32(plan.final_alpha_cumprod))
        if self.config.prediction_type == "v_prediction":
            eps = np.sqrt(ac_t) * eps + np.sqrt(f32(1) - ac_t) * sample
        coeff = np.sqrt(ac_prev / ac_t)
        denom = ac_t * np.sqrt(f32(1) - ac_prev) + np.sqrt(ac_t * (f32(1) - ac_t) * ac_prev)
        return coeff * sample - (ac_prev - ac_t) * eps / denom

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        ets, cur_sample = state
        sample32 = sample.float()
        out32 = model_output.float()
        # base-grid step ratio (the plan has N+1 steps for N base steps)
        ratio = plan.step_ratio or self.config.num_train_timesteps // (plan.num_steps - 1)
        t = int(plan.timesteps[i])
        if i == 1:  # the repeated warm-up evaluation
            eps = f32(0.5) * (out32 + ets[0])
            prev = self._prev_sample(plan, cur_sample, t + ratio, t, eps)
            return prev.to(sample.dtype), (ets, cur_sample)
        ets = (out32,) + ets[:3]
        if i == 0:
            eps, cur_sample = out32, sample32
        else:
            w = _AB[min(max(i, 2), 4) - 2]
            eps = sum(w[j] * e for j, e in enumerate(ets) if w[j] != 0)
        prev = self._prev_sample(plan, sample32, t, t - ratio, eps)
        return prev.to(sample.dtype), (ets, cur_sample)
