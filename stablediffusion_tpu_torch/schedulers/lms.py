"""Linear multistep (LMS, Adams-Bashforth order 4), k-diffusion sampler.

Port of ``stablediffusion_tpu/schedulers/lms.py``.  Each coefficient is the
integral of a Lagrange basis polynomial over [sigma_i, sigma_{i+1}]; the
basis is a product of at most three linear factors, so the JAX module
expands it into monomials and integrates it exactly, in fp32.  The port does
the same arithmetic in numpy float32 on the host, once per step.  Warm-up
ramps the order 1 -> 4 as history accumulates.  The state is the last four
derivatives (sample - x0) / sigma, newest first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.schedulers.common import Plan
from stablediffusion_tpu_torch.schedulers.euler import EulerDiscreteScheduler

_TINY = np.float32(1e-10)
_ORDER = 4  # diffusers LMSDiscreteScheduler.step(order=4)
f32 = np.float32


def lms_coefficients(sigmas: np.ndarray, i: int) -> np.ndarray:
    """[4] weights for history slots 0 (newest) .. 3 at step i:
    c_j = integral over [sigmas[i], sigmas[i+1]] of
    prod_{k != j, k <= i} (tau - a_k) / (a_j - a_k), a_k = sigmas[i - k];
    c_j = 0 for j > i (no history yet)."""
    a = [f32(sigmas[max(i - k, 0)]) for k in range(_ORDER)]
    lo, hi = f32(sigmas[i]), f32(sigmas[i + 1])
    coeffs = np.zeros(_ORDER, np.float32)
    for j in range(min(i, _ORDER - 1) + 1):
        p = [f32(1.0), f32(0.0), f32(0.0), f32(0.0)]  # ascending monomials
        for k in range(_ORDER):
            if k == j:
                continue
            if k <= i:  # slot k holds real history
                denom = a[j] - a[k]
                denom = f32(1.0) if denom == 0 else denom
                d0, d1 = -a[k] / denom, f32(1.0) / denom
            else:
                d0, d1 = f32(1.0), f32(0.0)
            p = [p[0] * d0, p[1] * d0 + p[0] * d1, p[2] * d0 + p[1] * d1,
                 p[3] * d0 + p[2] * d1]
        integral = f32(0.0)
        for m in range(4):
            integral = integral + p[m] * (hi ** (m + 1) - lo ** (m + 1)) / f32(m + 1)
        coeffs[j] = integral
    return coeffs


class LMSDiscreteScheduler(EulerDiscreteScheduler):
    order = 1

    def init_state(self, plan: Plan, sample_shape, device=None) -> tuple:
        return ((),)  # derivatives, newest first

    def step(self, plan: Plan, state, i: int, model_output: torch.Tensor,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        (derivs,) = state
        sigma = plan.sigmas[i]
        sample32 = sample.float()
        x0 = self._pred_x0(model_output.float(), sample32, sigma)
        deriv = (sample32 - x0) / np.maximum(sigma, _TINY)
        derivs = (deriv,) + derivs[: _ORDER - 1]
        coeffs = lms_coefficients(plan.sigmas, i)
        prev = sample32 + sum(coeffs[j] * d for j, d in enumerate(derivs))
        return prev.to(sample.dtype), (derivs,)
