"""DPM-Solver++ multistep (Lu et al. 2022), orders 1-3, with Karras sigmas
and the SDE variants: "DPM++ 2M", "2M Karras", "2M SDE Karras", "3M SDE"
and "3M SDE Karras" (k-diffusion's sample_dpmpp_3m_sde with eta = 1 in VP
coordinates; warm-up and order-lowered steps take the order-2 midpoint form,
diffusers' lower-order convention).

Port of ``stablediffusion_tpu/schedulers/dpm.py``.  The JAX step computes
every order's update and selects one with ``jnp.where``; with a Python step
index the port computes only the selected one.  The state holds the
previous x0 prediction (two for order 3) in fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    _need_noise,
    karras_sigma_grid,
    sigmas_from_alphas_cumprod,
    timesteps_from_sigmas,
)

_TINY = np.float32(1e-10)
f32 = np.float32


def dpm_timestep_grid(config: SchedulerConfig, num_steps: int) -> np.ndarray:
    """DPM/UniPC grid: N+1 anchor points with the last dropped (the terminal
    anchor is the appended final sigma)."""
    T = config.num_train_timesteps
    spacing = config.timestep_spacing
    if spacing == "linspace":
        ts = np.linspace(0, T - 1, num_steps + 1).round()[::-1][:-1].astype(np.int64)
    elif spacing == "leading":
        ratio = T // (num_steps + 1)
        ts = (np.arange(num_steps + 1) * ratio).round()[::-1][:-1].astype(np.int64)
        ts += config.steps_offset
    elif spacing == "trailing":
        ratio = T / num_steps
        ts = np.arange(T, 0, -ratio).round().astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing {spacing!r}")
    return ts


def alpha_sigma(sigma):
    """(alpha_t, sigma_t) of a VE sigma in fp32: alpha = 1/sqrt(sigma^2+1)."""
    alpha_t = f32(1.0) / np.sqrt(sigma**2 + f32(1.0))
    return alpha_t, sigma * alpha_t


def lambda_of(alpha, sig):
    return np.log(alpha) - np.log(np.maximum(sig, _TINY))


def convert_to_x0(prediction_type: str, model_output, sample, sigma):
    alpha_t, sigma_t = alpha_sigma(sigma)
    if prediction_type == "epsilon":
        return (sample - sigma_t * model_output) / alpha_t
    if prediction_type == "v_prediction":
        return alpha_t * sample - sigma_t * model_output
    if prediction_type == "sample":
        return model_output
    raise ValueError(prediction_type)


class DPMSolverMultistepScheduler(BaseScheduler):
    """algorithm_type "dpmsolver++" (ODE) or "sde-dpmsolver++"."""

    order = 1  # one model evaluation per step

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        super().__init__(config)
        if config.solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order {config.solver_order}: orders 1-3")
        self.sde = config.algorithm_type == "sde-dpmsolver++"

    def uses_noise(self) -> bool:
        return self.sde

    def plan(self, num_steps: int, timesteps: Optional[np.ndarray] = None,
             sigmas: Optional[np.ndarray] = None) -> Plan:
        if timesteps is not None and sigmas is not None:
            raise ValueError("pass only one of `timesteps` or `sigmas`")
        if timesteps is not None and self.config.use_karras_sigmas:
            raise ValueError("cannot use custom `timesteps` with use_karras_sigmas=True")
        full_sigmas = sigmas_from_alphas_cumprod(self._alphas_cumprod_np)
        if sigmas is not None:
            sigmas = np.asarray(sigmas, np.float64)
            timesteps = timesteps_from_sigmas(sigmas, full_sigmas).round()
        else:
            if timesteps is None:
                timesteps = dpm_timestep_grid(self.config, num_steps)
            timesteps = np.asarray(timesteps, np.float64)
            sigmas = np.interp(timesteps, np.arange(len(full_sigmas)), full_sigmas)
            if self.config.use_karras_sigmas:
                sigmas = karras_sigma_grid(float(sigmas[-1]), float(sigmas[0]), len(timesteps))
                timesteps = timesteps_from_sigmas(sigmas, full_sigmas).round()
        if self.config.final_sigmas_type == "zero":
            sigma_last = 0.0
        else:
            sigma_last = float(sigmas_from_alphas_cumprod(self._alphas_cumprod_np[:1])[0])
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        return Plan(
            timesteps=np.asarray(timesteps, np.float32),
            sigmas=sigmas,
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=1.0,
            final_alpha_cumprod=float(np.float32(self._alphas_cumprod_np[0])),
            num_steps=len(timesteps),
        )

    def init_state(self, plan: Plan, sample_shape, device=None) -> tuple:
        # previous x0 prediction(s), zeros before the first step
        n = 2 if self.config.solver_order == 3 else 1
        return tuple(torch.zeros(sample_shape, device=device) for _ in range(n))

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        third_order = self.config.solver_order == 3
        x0_prev = state[0]
        N = plan.num_steps
        s = plan.sigmas
        sigma_s0, sigma_t, sigma_s1 = s[i], s[i + 1], s[max(i - 1, 0)]

        sample32 = sample.float()
        x0 = convert_to_x0(self.config.prediction_type, model_output.float(),
                           sample32, sigma_s0)

        alpha_t, sig_t = alpha_sigma(sigma_t)
        alpha_s0, sig_s0 = alpha_sigma(sigma_s0)
        lambda_t = lambda_of(alpha_t, sig_t)
        lambda_s0 = lambda_of(alpha_s0, sig_s0)
        lambda_s1 = lambda_of(*alpha_sigma(sigma_s1))
        h = lambda_t - lambda_s0
        h_0 = lambda_s0 - lambda_s1
        r0 = h_0 / (f32(1.0) if h == 0 else h)
        exp_mh = (sig_t * alpha_s0) / (sig_s0 * alpha_t)  # exact 0 at sigma_t = 0

        # order selection (diffusers parity): first order at warm-up (i == 0)
        # and at the final step when the final sigma is zero (lambda diverges
        # there) or the run is short
        lower_final = i == N - 1 and (self.config.final_sigmas_type == "zero" or N < 15)
        use_first = i == 0 or lower_final or self.config.solver_order == 1
        use_second = i == 1 or (i == N - 2 and N < 15)
        if use_first:
            order = 1
        elif use_second or not third_order:
            order = 2
        else:
            order = 3

        D0 = x0
        if order >= 2:
            D1 = (x0 - x0_prev) / (f32(1.0) if r0 == 0 else r0)
        if order == 3:
            sigma_s2 = s[max(i - 2, 0)]
            lambda_s2 = lambda_of(*alpha_sigma(sigma_s2))
            h_1 = lambda_s1 - lambda_s2
            hh = f32(1.0) if h == 0 else h
            r1 = h_1 / hh
            D1_1 = (x0_prev - state[1]) / (f32(1.0) if r1 == 0 else r1)
            rsum = f32(1.0) if r0 + r1 == 0 else r0 + r1
            D1_3 = D1 + (r0 / rsum) * (D1 - D1_1)
            D2 = (D1 - D1_1) / rsum

        if not self.sde:
            emh1 = exp_mh - f32(1.0)  # expm1(-h)
            prev = (sig_t / sig_s0) * sample32 - alpha_t * emh1 * D0
            if order == 2:
                prev = prev - f32(0.5) * alpha_t * emh1 * D1
            elif order == 3:
                # Lu et al. 2022 eq. (3.3) / diffusers third-order dpmsolver++
                prev = (
                    (sig_t / sig_s0) * sample32
                    - alpha_t * emh1 * D0
                    + alpha_t * (emh1 / hh + f32(1.0)) * D1_3
                    - alpha_t * ((emh1 + h) / (hh * hh) - f32(0.5)) * D2
                )
        else:
            noise = _need_noise(self, noise)
            exp_m2h = exp_mh**2
            prev = (
                (sig_t / sig_s0) * exp_mh * sample32
                + alpha_t * (f32(1.0) - exp_m2h) * D0
                + sig_t * np.sqrt(np.maximum(f32(1.0) - exp_m2h, f32(0.0))) * noise
            )
            if order == 2:
                prev = prev + f32(0.5) * alpha_t * (f32(1.0) - exp_m2h) * D1
            elif order == 3:
                # k-diffusion sample_dpmpp_3m_sde with eta = 1: h_eta = 2h
                h_eta = f32(1.0) if h == 0 else f32(2.0) * h
                phi2 = (exp_m2h - f32(1.0)) / h_eta + f32(1.0)
                phi3 = phi2 / h_eta - f32(0.5)
                prev = prev + alpha_t * (phi2 * D1_3 - phi3 * D2)
        new_state = (x0, x0_prev) if third_order else (x0,)
        return prev.to(sample.dtype), new_state

    def add_noise_index(self, plan: Plan, original, noise, i: int):
        alpha_t, sigma_t = alpha_sigma(plan.sigmas[i])
        return (alpha_t * original.float() + sigma_t * noise.float()).to(original.dtype)
