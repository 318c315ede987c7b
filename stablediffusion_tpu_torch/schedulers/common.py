"""Shared scheduler math: beta schedules, timestep grids, sigma tables, the
per-run Plan, step noise, and the base class.

Port of ``stablediffusion_tpu/schedulers/common.py``.  Every scheduler has
the JAX interface: ``plan(n, timesteps=, sigmas=)`` builds the tables of one
run and ``step(plan, state, i, model_output, sample, noise=None)`` returns
``(sample, state)``.  The tables are host-side numpy, as in the JAX package;
the Plan holds them as numpy arrays and Python numbers, because the port's
denoise loop is a Python loop and not a traced scan: the step index is a
Python int, so where the JAX step selects between branches with
``jnp.where`` the port takes one branch, and the per-step scalars are
numpy float32, as the JAX step computes them in fp32.  The state is a tuple
of fp32 tensors.  Stochastic steps (``uses_noise()``) take their standard
normal noise as an argument: the pipeline draws it with ``step_noise`` from
a ``torch.Generator`` (or one per sample), and parity tests inject JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

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


def resolve_custom_schedule(num_steps, timesteps, sigmas):
    """At most one of `timesteps` / `sigmas`; a given list overrides
    `num_steps`."""
    if timesteps is not None and sigmas is not None:
        raise ValueError("pass only one of `timesteps` or `sigmas`")
    if timesteps is not None:
        num_steps = len(timesteps)
    elif sigmas is not None:
        num_steps = len(sigmas)
    return num_steps


def reject_custom_sigmas(scheduler, sigmas) -> None:
    if sigmas is not None:
        raise ValueError(
            f"{type(scheduler).__name__} does not support custom `sigmas`"
        )


def karras_sigma_grid(
    sigma_min: float, sigma_max: float, num_steps: int, rho: float = 7.0
) -> np.ndarray:
    """Karras et al. 2022 sigma spacing (descending, without terminal 0)."""
    ramp = np.linspace(0, 1, num_steps)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def sigmas_from_alphas_cumprod(alphas_cumprod: np.ndarray) -> np.ndarray:
    return np.sqrt((1 - alphas_cumprod) / alphas_cumprod)


def timesteps_from_sigmas(sigmas: np.ndarray, full_sigmas: np.ndarray) -> np.ndarray:
    """Map sigmas back to (fractional) train timesteps by log-sigma
    interpolation over the full training table (k-diffusion convention)."""
    log_sigmas = np.log(full_sigmas)
    ts = np.zeros_like(sigmas)
    for i, s in enumerate(sigmas):
        ls = np.log(np.maximum(s, 1e-10))
        dists = ls - log_sigmas[:, None]
        low_idx = (
            np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(max=len(log_sigmas) - 2)
        )[0]
        high_idx = low_idx + 1
        low, high = log_sigmas[low_idx], log_sigmas[high_idx]
        w = np.clip((low - ls) / (low - high), 0, 1)
        ts[i] = (1 - w) * low_idx + w * high_idx
    return ts


@dataclass(frozen=True)
class Plan:
    """Per-run tables of one denoise run."""

    timesteps: np.ndarray  # [N] int64, or float32 for sigma-interpolated grids
    sigmas: np.ndarray  # [N+1] float32 (terminal appended); zeros where unused
    alphas_cumprod: np.ndarray  # [T] float32
    init_noise_sigma: float
    final_alpha_cumprod: float  # DDIM family, float32-representable
    num_steps: int
    order: int = 1  # scan indices per sampler step (2: Heun's interleaved plan)
    # train timesteps per inference step of the ORIGINAL (unsliced) grid:
    # DDIM/PNDM/DDPM keep using it after an img2img strength slice
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


def broadcast_to_sample(x: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """A per-batch [B] (or scalar) tensor with trailing dims to broadcast
    against sample [B, ...]."""
    return x.reshape(x.shape + (1,) * (sample.dim() - x.dim()))


Generators = Union[torch.Generator, Sequence[torch.Generator]]


def step_noise(generator: Generators, like: torch.Tensor) -> torch.Tensor:
    """Standard normal fp32 noise of `like`'s shape on its device: from one
    generator, or from a list of one generator per sample, each sample's
    noise from its own stream (so a sample's trajectory depends on its own
    seed only, whatever batch it runs in)."""
    if isinstance(generator, torch.Generator):
        return torch.randn(like.shape, generator=generator, device=like.device)
    if len(generator) != like.shape[0]:
        raise ValueError(f"{len(generator)} generators for a batch of {like.shape[0]}")
    return torch.stack([torch.randn(like.shape[1:], generator=g, device=like.device)
                        for g in generator])


def _need_noise(scheduler, noise: Optional[torch.Tensor]) -> torch.Tensor:
    if noise is None:
        raise ValueError(f"{type(scheduler).__name__} step needs its noise (step_noise)")
    return noise.float()


class BaseScheduler:
    """Config-bound tables and the training-side ops; subclasses implement
    ``plan`` and ``step``."""

    order = 1

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self._alphas_cumprod_np = make_alphas_cumprod(config)
        self.alphas_cumprod = self._alphas_cumprod_np.astype(np.float32)

    def _sqrt_ac(self, timesteps: torch.Tensor, sample: torch.Tensor):
        """(sqrt(alpha_bar_t), sqrt(1 - alpha_bar_t)) in fp32, broadcast
        against sample."""
        table = torch.as_tensor(self.alphas_cumprod, device=sample.device)
        ac = table[torch.as_tensor(timesteps, device=sample.device).long()]
        return (broadcast_to_sample(ac.sqrt(), sample),
                broadcast_to_sample((1.0 - ac).sqrt(), sample))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """sqrt(ab_t) x0 + sqrt(1 - ab_t) noise (forward diffusion)."""
        a, s = self._sqrt_ac(timesteps, original)
        return (a * original + s * noise).to(original.dtype)

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """sqrt(ab_t) noise - sqrt(1 - ab_t) x0 (the v-prediction target)."""
        a, s = self._sqrt_ac(timesteps, sample)
        return (a * noise - s * sample).to(sample.dtype)

    # -- inference-side ops --------------------------------------------------
    def scale_model_input(self, plan: Plan, sample: torch.Tensor, i: int):
        return sample

    def init_state(self, plan: Plan, sample_shape, device=None) -> tuple:
        return ()

    def uses_noise(self) -> bool:
        """Whether `step` consumes noise (ancestral / SDE variants)."""
        return False

    def add_noise_index(self, plan: Plan, original: torch.Tensor,
                        noise: torch.Tensor, i: int) -> torch.Tensor:
        """add_noise at inference step index i (img2img latents)."""
        return self.add_noise(original, noise, int(plan.timesteps[i]))
