"""UniPC (Zhao et al. 2023): unified predictor-corrector multistep, order 2,
B(h) = expm1(h) ("bh2") or h ("bh1").

Port of ``stablediffusion_tpu/schedulers/unipc.py``.  The corrector at step
i refines the sample that step i-1's predictor produced, with the current
model evaluation; then the predictor advances.  The state holds the last two
x0 predictions, the pre-predictor sample and the predictor order of step i-1
(the corrector reuses it).  With a Python step index the port computes only
the branch that the JAX step's ``jnp.where`` selects.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import SchedulerConfig
from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    sigmas_from_alphas_cumprod,
    timesteps_from_sigmas,
)
from stablediffusion_tpu_torch.schedulers.dpm import (
    alpha_sigma,
    convert_to_x0,
    dpm_timestep_grid,
)

_TINY = np.float32(1e-10)
f32 = np.float32


def _lambda(sigma):
    alpha_t, sigma_t = alpha_sigma(sigma)
    return np.log(alpha_t) - np.log(np.maximum(sigma_t, _TINY))


class UniPCScheduler(BaseScheduler):
    order = 1

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        super().__init__(config)
        if config.solver_order not in (1, 2) or config.solver_type not in ("bh1", "bh2"):
            raise ValueError("UniPC: solver_order 1 or 2, solver_type bh1 or bh2")

    def plan(self, num_steps: int, timesteps: Optional[np.ndarray] = None,
             sigmas: Optional[np.ndarray] = None) -> Plan:
        if timesteps is not None and sigmas is not None:
            raise ValueError("pass only one of `timesteps` or `sigmas`")
        full_sigmas = sigmas_from_alphas_cumprod(self._alphas_cumprod_np)
        if sigmas is not None:
            sigmas = np.asarray(sigmas, np.float64)
            timesteps = timesteps_from_sigmas(sigmas, full_sigmas).round()
        else:
            if timesteps is None:
                timesteps = dpm_timestep_grid(self.config, num_steps)
            timesteps = np.asarray(timesteps, np.float64)
            sigmas = np.interp(timesteps, np.arange(len(full_sigmas)), full_sigmas)
        sigma_last = 0.0 if self.config.final_sigmas_type == "zero" else float(full_sigmas[0])
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
        z = torch.zeros(sample_shape, device=device)
        # x0 at step i-1, x0 at step i-2, pre-predictor sample of step i-1,
        # the predictor order of step i-1
        return (z, z, z, 0)

    def _bh_coeffs(self, h):
        """(h_phi_1, B_h, b1, b2) for hh = -h, guarded against h ~ 0."""
        hh = -h
        hh_safe = f32(-1.0) if abs(hh) < _TINY else hh
        h_phi_1 = np.expm1(hh)  # e^{-h} - 1
        B_h = hh if self.config.solver_type == "bh1" else h_phi_1
        B_h_safe = f32(1.0) if abs(B_h) < _TINY else B_h
        h_phi_k1 = h_phi_1 / hh_safe - f32(1.0)
        b1 = h_phi_k1 * f32(1.0) / B_h_safe
        h_phi_k2 = h_phi_k1 / hh_safe - f32(0.5)
        b2 = h_phi_k2 * f32(2.0) / B_h_safe
        return h_phi_1, B_h, b1, b2

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        m_prev, m_prev2, last_sample, prev_order = state
        N = plan.num_steps
        s = plan.sigmas
        sample32 = sample.float()
        sigma_cur = s[i]
        m_this = convert_to_x0(self.config.prediction_type, model_output.float(),
                               sample32, sigma_cur)

        # corrector: refine step i-1's predictor output
        if i > 0:
            sigma_c0 = s[i - 1]  # where the predictor started
            lambda_c0 = _lambda(sigma_c0)
            h_c = _lambda(sigma_cur) - lambda_c0
            alpha_ct, sig_ct = alpha_sigma(sigma_cur)
            _, sig_c0 = alpha_sigma(sigma_c0)
            h_phi_1c, B_hc, b1c, b2c = self._bh_coeffs(h_c)
            x_t_c = (sig_ct / np.maximum(sig_c0, _TINY)) * last_sample - (
                alpha_ct * h_phi_1c) * m_prev
            D1_t = m_this - m_prev
            if prev_order >= 2:
                # order 2: rks = [r0, 1], R = [[1, 1], [r0, 1]], a 2x2 solve
                lambda_c1 = _lambda(s[max(i - 2, 0)])
                h_c_safe = f32(1.0) if abs(h_c) < _TINY else h_c
                r0_c = (lambda_c1 - lambda_c0) / h_c_safe
                det = f32(1.0) if abs(f32(1.0) - r0_c) < _TINY else f32(1.0) - r0_c
                rho1_c = (b1c - b2c) / det
                rho2_c = (b2c - r0_c * b1c) / det
                r0_c_safe = f32(1.0) if abs(r0_c) < _TINY else r0_c
                D1_hist = (m_prev2 - m_prev) / r0_c_safe
                sample_eff = x_t_c - alpha_ct * B_hc * (rho1_c * D1_hist + rho2_c * D1_t)
            else:
                sample_eff = x_t_c - alpha_ct * B_hc * (f32(0.5) * D1_t)  # rhos_c = [0.5]
        else:
            sample_eff = sample32
        # the x0 history keeps the pre-corrector conversion, as diffusers'
        # convert_model_output does

        # predictor: advance from sigma_cur to sigmas[i + 1]
        sigma_t = s[i + 1]
        alpha_t, sig_t = alpha_sigma(sigma_t)
        _, sig_s0 = alpha_sigma(sigma_cur)
        lambda_s0 = _lambda(sigma_cur)
        h = _lambda(sigma_t) - lambda_s0
        h_phi_1, B_h, _, _ = self._bh_coeffs(h)
        x_t_ = (sig_t / np.maximum(sig_s0, _TINY)) * sample_eff - (alpha_t * h_phi_1) * m_this
        this_order = min(self.config.solver_order, N - i, i + 1)
        if this_order >= 2:
            # rhos_p = [0.5]; D1 from the history
            lambda_s1 = _lambda(s[max(i - 1, 0)])
            h_safe = f32(1.0) if abs(h) < _TINY else h
            r0_p = (lambda_s1 - lambda_s0) / h_safe
            r0_p_safe = f32(1.0) if abs(r0_p) < _TINY else r0_p
            D1_p = (m_prev - m_this) / r0_p_safe
            prev = x_t_ - alpha_t * B_h * (f32(0.5) * D1_p)
        else:
            prev = x_t_
        return prev.to(sample.dtype), (m_this, m_prev, sample_eff, this_order)

    def add_noise_index(self, plan: Plan, original, noise, i: int):
        alpha_t, sigma_t = alpha_sigma(plan.sigmas[i])
        return (alpha_t * original.float() + sigma_t * noise.float()).to(original.dtype)
