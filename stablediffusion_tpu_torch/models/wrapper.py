"""SDModel — configs, modules, tokenizers and scheduler of one model.

Port of ``stablediffusion_tpu/models/wrapper.py:29-85`` and its
``load_refiner`` (:132-152).  The JAX holder pairs configs with param trees;
here it pairs them with ``nn.Module``s, all on one device.  SDXL is told by
the presence of the second text tower (``text_encoder_2``, bigG, with its
``tokenizer_2``); an SDXL model may also hold a refiner UNet.  The scheduler
switches by name over the shared config (``set_scheduler``); checkpoints
load and save through ``io/loader.py``.  LoRA adapters raise (ROADMAP §1
item 14); quantization, IP-Adapter and textual inversion are absent, so the
serving handler's ``hasattr`` guards answer "not supported" as they do for
the JAX package.  ControlNet is not ported (item 15).
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
    # SDXL's second tower (its presence makes the model SDXL, as in JAX)
    text_encoder_2_config: Optional[CLIPTextConfig] = None
    text_encoder_2: Optional[CLIPTextModel] = None
    tokenizer_2: Any = None
    # the SDXL refiner's UNet, loaded on demand (load_refiner)
    refiner_config: Optional[UNetConfig] = None
    refiner: Optional[UNet2DConditionModel] = None

    _scheduler: Optional[Any] = field(default=None, repr=False)

    def __post_init__(self):
        modules = (self.unet, self.vae, self.text_encoder, self.text_encoder_2, self.refiner)
        devices = {p.device for m in modules if m is not None for p in m.parameters()}
        if len(devices) != 1:
            raise ValueError(f"SDModel modules span devices {sorted(map(str, devices))}")

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def is_sdxl(self) -> bool:
        return self.text_encoder_2 is not None

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

    def load_refiner(self, path: Optional[str] = None) -> None:
        """Load a refiner UNet from a diffusers-layout folder onto the
        model's device, in the UNet's dtype; only its ``unet/`` is read.
        `path` None resolves the default refiner checkpoint's folder under
        the model dir.  A no-op when a refiner is loaded."""
        if self.refiner is not None:
            return
        from stablediffusion_tpu_torch.io.loader import load_unet, resolve_checkpoint

        if path is None:
            path = resolve_checkpoint(self.model_type, "refiner")
        dtype = next(self.unet.parameters()).dtype
        self.refiner_config, self.refiner = load_unet(path, self.device, dtype)

    def load_loras(self, loras, lora_dir: Optional[str] = None) -> None:
        raise NotImplementedError(_LORA_LATER)

    def delete_adapters(self) -> None:
        raise NotImplementedError(_LORA_LATER)
