"""Euler discrete and Euler-ancestral samplers (k-diffusion family).

Port of ``stablediffusion_tpu/schedulers/euler.py``.  They work in the sigma
parametrization: latents carry x0 + sigma * eps, ``scale_model_input``
divides by sqrt(sigma^2 + 1) before the UNet, and txt2img noise is scaled by
``init_noise_sigma``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    _need_noise,
    karras_sigma_grid,
    make_timestep_grid,
    sigmas_from_alphas_cumprod,
    timesteps_from_sigmas,
)

f32 = np.float32


class EulerDiscreteScheduler(BaseScheduler):
    order = 1

    def plan(self, num_steps: int, timesteps: Optional[np.ndarray] = None,
             sigmas: Optional[np.ndarray] = None) -> Plan:
        if timesteps is not None and sigmas is not None:
            raise ValueError("pass only one of `timesteps` or `sigmas`")
        if timesteps is not None and self.config.use_karras_sigmas:
            raise ValueError("cannot use custom `timesteps` with use_karras_sigmas=True")
        full_sigmas = sigmas_from_alphas_cumprod(self._alphas_cumprod_np)
        if sigmas is not None:
            # a user sigma list (descending, no terminal 0): timesteps by
            # log-sigma interpolation; the Karras branch is skipped
            sigmas = np.asarray(sigmas, np.float64)
            timesteps = timesteps_from_sigmas(sigmas, full_sigmas)
        else:
            if timesteps is None:
                timesteps = make_timestep_grid(self.config, num_steps).astype(np.float64)
            else:
                timesteps = np.asarray(timesteps, np.float64)
            sigmas = np.interp(timesteps, np.arange(len(full_sigmas)), full_sigmas)
            if self.config.use_karras_sigmas:
                sigmas = karras_sigma_grid(sigmas[-1], sigmas[0], len(timesteps))
                timesteps = timesteps_from_sigmas(sigmas, full_sigmas)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)

        if self.config.timestep_spacing in ("linspace", "trailing"):
            init_noise_sigma = float(sigmas.max())
        else:
            init_noise_sigma = float((sigmas.max() ** 2 + 1) ** 0.5)
        return Plan(
            timesteps=np.asarray(timesteps, np.float32),
            sigmas=sigmas,
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=float(np.float32(init_noise_sigma)),
            final_alpha_cumprod=float(np.float32(self._alphas_cumprod_np[0])),
            num_steps=len(timesteps),
        )

    def scale_model_input(self, plan: Plan, sample: torch.Tensor, i: int):
        sigma = plan.sigmas[i]
        return (sample.float() / np.sqrt(sigma**2 + f32(1.0))).to(sample.dtype)

    def _pred_x0(self, model_output, sample, sigma):
        pt = self.config.prediction_type
        if pt == "epsilon":
            return sample - sigma * model_output
        if pt == "v_prediction":
            return model_output * (-sigma / np.sqrt(sigma**2 + f32(1))) + sample / (
                sigma**2 + f32(1))
        if pt == "sample":
            return model_output
        raise ValueError(pt)

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        sigma = plan.sigmas[i]
        sample32 = sample.float()
        x0 = self._pred_x0(model_output.float(), sample32, sigma)
        derivative = (sample32 - x0) / sigma
        dt = plan.sigmas[i + 1] - sigma
        prev = sample32 + derivative * dt
        return prev.to(sample.dtype), state

    def add_noise_index(self, plan: Plan, original, noise, i: int):
        """In sigma space: x0 + sigma * noise."""
        sigma = plan.sigmas[i]
        return (original.float() + sigma * noise.float()).to(original.dtype)


class EulerAncestralScheduler(EulerDiscreteScheduler):
    """Euler step to sigma_down plus fresh noise of std sigma_up."""

    def uses_noise(self) -> bool:
        return True

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        noise = _need_noise(self, noise)
        sigma_from = plan.sigmas[i]
        sigma_to = plan.sigmas[i + 1]
        sample32 = sample.float()
        x0 = self._pred_x0(model_output.float(), sample32, sigma_from)

        sigma_up2 = sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2
        sigma_up = np.sqrt(np.maximum(sigma_up2, f32(0.0)))
        sigma_down = np.sqrt(np.maximum(sigma_to**2 - sigma_up2, f32(0.0)))

        derivative = (sample32 - x0) / sigma_from
        dt = sigma_down - sigma_from
        prev = sample32 + derivative * dt
        prev = prev + noise * sigma_up
        return prev.to(sample.dtype), state
