"""Shared scheduler math: beta schedules, timestep grids, the per-run Plan.

Port of ``stablediffusion_tpu/schedulers/common.py:34-95,159-205``.  The
tables are host-side numpy, as in the JAX package; the Plan holds them as
numpy arrays and Python numbers, since the port's denoise loop is a Python
loop and not a traced scan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import SchedulerConfig


def make_betas(config: SchedulerConfig) -> np.ndarray:
    T = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = (
            np.linspace(
                config.beta_start**0.5, config.beta_end**0.5, T, dtype=np.float64
            )
            ** 2
        )
    elif config.beta_schedule == "squaredcos_cap_v2":
        # cosine schedule (Nichol & Dhariwal)
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(T, dtype=np.float64)
        betas = np.minimum(1 - alpha_bar((ts + 1) / T) / alpha_bar(ts / T), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule {config.beta_schedule!r}")
    return betas


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Rescale so the final alpha_bar is zero (arXiv 2305.08891 §3)."""
    ab_sqrt = np.sqrt(alphas_cumprod)
    ab0, abT = ab_sqrt[0], ab_sqrt[-1]
    ab_sqrt = ab_sqrt - abT
    ab_sqrt = ab_sqrt * ab0 / (ab0 - abT)
    return ab_sqrt**2


def make_alphas_cumprod(config: SchedulerConfig) -> np.ndarray:
    ac = np.cumprod(1.0 - make_betas(config))
    if config.rescale_betas_zero_snr:
        ac = _rescale_zero_terminal_snr(ac)
    return ac


def make_timestep_grid(config: SchedulerConfig, num_steps: int) -> np.ndarray:
    """Descending integer timesteps for `num_steps` inference steps."""
    T = config.num_train_timesteps
    spacing = config.timestep_spacing
    if spacing == "leading":
        ratio = T // num_steps
        ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
        ts += config.steps_offset
    elif spacing == "trailing":
        ratio = T / num_steps
        ts = np.arange(T, 0, -ratio).round().astype(np.int64) - 1
    elif spacing == "linspace":
        ts = np.linspace(0, T - 1, num_steps).round()[::-1].astype(np.int64)
    else:
        raise ValueError(f"unknown timestep_spacing {spacing!r}")
    return ts


@dataclass(frozen=True)
class Plan:
    """Per-run tables of one denoise run."""

    timesteps: np.ndarray  # [N] int64
    sigmas: np.ndarray  # [N+1] float32; zeros where unused
    alphas_cumprod: np.ndarray  # [T] float32
    init_noise_sigma: float
    final_alpha_cumprod: float  # DDIM family, float32-representable
    num_steps: int
    order: int = 1
    # train timesteps per inference step of the requested grid
    step_ratio: int = 0


def prediction_to_x0_eps(
    prediction_type: str,
    model_output: torch.Tensor,
    sample: torch.Tensor,
    alpha_t: float,
    sigma_t: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_x0, pred_eps) from a model output, given
    sample = alpha_t * x0 + sigma_t * eps  (alpha_t = sqrt(alpha_bar))."""
    if prediction_type == "epsilon":
        eps = model_output
        x0 = (sample - sigma_t * eps) / alpha_t
    elif prediction_type == "v_prediction":
        x0 = alpha_t * sample - sigma_t * model_output
        eps = alpha_t * model_output + sigma_t * sample
    elif prediction_type == "sample":
        x0 = model_output
        eps = (sample - alpha_t * x0) / sigma_t
    else:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    return x0, eps
