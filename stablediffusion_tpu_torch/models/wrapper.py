"""SDModel — configs, modules, tokenizer and scheduler of one model.

Port of the SD1.5 subset of ``stablediffusion_tpu/models/wrapper.py:29-85``.
The JAX holder pairs configs with param trees; here it pairs them with
``nn.Module``s, all on one device.  The scheduler switches by name over the
shared config (``set_scheduler``); checkpoints load and save through
``io/loader.py``.  LoRA adapters raise (ROADMAP §1 item 14); quantization,
IP-Adapter and textual inversion are absent, so the serving handler's
``hasattr`` guards answer "not supported" as they do for the JAX package.
ControlNet, the SDXL second tower and the refiner are not ported.
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

_LORA_LATER = ("LoRA adapters are not ported yet: they come with ROADMAP §1 "
               "item 14 (lora/formats.py and the adapter lifecycle)")


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
    model_type: str = "sd15"
    path: Optional[str] = None  # the checkpoint folder it was loaded from

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
    def is_sdxl(self) -> bool:
        return False  # the SDXL second tower comes with ROADMAP §1 item 13

    @property
    def vae_scale_factor(self) -> int:
        return self.vae_config.vae_scale_factor

    @property
    def scheduler(self):
        if self._scheduler is None:
            self._scheduler = make_scheduler(self.scheduler_name, self.scheduler_config)
        return self._scheduler

    def set_scheduler(self, name: str) -> None:
        """Idempotent switch by registry name over the shared config."""
        if name == self.scheduler_name and self._scheduler is not None:
            return
        self._scheduler = make_scheduler(name, self.scheduler_config)
        self.scheduler_name = name

    def load_loras(self, loras, lora_dir: Optional[str] = None) -> None:
        raise NotImplementedError(_LORA_LATER)

    def delete_adapters(self) -> None:
        raise NotImplementedError(_LORA_LATER)
