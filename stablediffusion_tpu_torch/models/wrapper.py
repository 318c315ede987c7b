"""SDModel — configs, modules, tokenizer and scheduler of one model.

Port of the SD1.5 subset of ``stablediffusion_tpu/models/wrapper.py:29-75``.
The JAX holder pairs configs with param trees; here it pairs them with
``nn.Module``s, all on one device.  LoRA, ControlNet, IP-Adapter, the SDXL
second tower and the refiner are not ported in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from stablediffusion_tpu_torch.core.config import (
    CLIPTextConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.schedulers import make_scheduler


@dataclass
class SDModel:
    unet_config: UNetConfig
    unet: UNet2DConditionModel
    vae_config: VAEConfig
    vae: AutoencoderKL
    text_encoder_config: CLIPTextConfig
    text_encoder: CLIPTextModel
    tokenizer: Any
    scheduler_config: SchedulerConfig = field(default_factory=SchedulerConfig)
    scheduler_name: str = "DDIM"

    _scheduler: Optional[Any] = field(default=None, repr=False)

    def __post_init__(self):
        devices = {
            p.device for m in (self.unet, self.vae, self.text_encoder)
            for p in m.parameters()
        }
        if len(devices) != 1:
            raise ValueError(f"SDModel modules span devices {sorted(map(str, devices))}")

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def vae_scale_factor(self) -> int:
        return self.vae_config.vae_scale_factor

    @property
    def scheduler(self):
        if self._scheduler is None:
            self._scheduler = make_scheduler(self.scheduler_name, self.scheduler_config)
        return self._scheduler
