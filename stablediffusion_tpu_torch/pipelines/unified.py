"""Text-to-image pipeline: SD1.5, DDIM, classifier-free guidance.

Port of the txt2img subset of ``stablediffusion_tpu/pipelines/unified.py``:
``encode_prompt`` (positive and negative prompts, ``num_images_per_prompt``),
``_clip_encode`` with mode "last", the no-extras path of ``_denoise`` as a
Python loop, the latent init, ``_vae_decode`` (with the latents_mean/std
branch, ``force_upcast`` and ``vae_dtype``) and the "np" / "uint8" /
"latents" outputs.  img2img, inpainting, prompt weighting, LoRA, clip skip,
SDXL and the extensions are later slices.

Public layouts are the JAX package's: ``latents`` in and ``output_type=
"latents"`` out are NHWC [B, h, w, 4]; images are NHWC [B, H, W, 3].  The
denoise loop itself runs on NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import default_dtype, resolve_device
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.utils import images as img_utils


@dataclass
class SDPipelineOutput:
    images: Optional[np.ndarray]  # [B, H, W, 3] float32 in [0, 1] or uint8
    latents: Optional[torch.Tensor]  # NHWC, when output_type="latents"
    seed: int


class StableDiffusionUnifiedPipeline:
    """txt2img on one device: ``cuda`` unless `device="cpu"` is passed."""

    def __init__(
        self,
        do_cfg: bool = True,
        output_type: str = "np",  # "np" ([0,1] f32) | "uint8" | "latents"
        dtype: Optional[torch.dtype] = None,  # default: bf16 on cuda, fp32 on cpu
        vae_dtype: Optional[torch.dtype] = None,  # overrides force_upcast
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        self.do_cfg = do_cfg
        self.output_type = output_type
        self.dtype = dtype or default_dtype(self.device)
        self.vae_dtype = vae_dtype

    # -- prompt encoding (unified.py:438-587, SD1.5 subset) -----------------
    @torch.no_grad()
    def _clip_encode(self, model: SDModel, texts: List[str]) -> torch.Tensor:
        ids = torch.from_numpy(model.tokenizer(texts)).to(self.device)
        return model.text_encoder(ids).last_hidden_state

    def encode_prompt(
        self,
        model: SDModel,
        prompt: Union[str, List[str]],
        negative_prompt: Union[str, List[str], None] = None,
        num_images_per_prompt: int = 1,
        do_cfg: bool = True,
    ):
        """-> (embeds, neg_embeds or None), each [B * n, 77, D]."""
        prompt = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompt)
        embeds = self._clip_encode(model, prompt)
        neg_embeds = None
        if do_cfg:
            negative_prompt = negative_prompt or ""
            neg = (
                [negative_prompt] * B
                if isinstance(negative_prompt, str)
                else list(negative_prompt)
            )
            if len(neg) != B:
                raise ValueError(f"negative_prompt batch {len(neg)} != prompt batch {B}")
            neg_embeds = self._clip_encode(model, neg)
        n = num_images_per_prompt
        tile = lambda x: x.repeat_interleave(n, dim=0) if x is not None else None
        return tile(embeds), tile(neg_embeds)

    # -- stages -------------------------------------------------------------
    @torch.no_grad()
    def _denoise(self, model: SDModel, latents: torch.Tensor, embeds: torch.Tensor,
                 plan, guidance_scale: float, do_cfg: bool) -> torch.Tensor:
        """The hot loop (unified.py:266-374, no extras): latents NCHW in the
        compute dtype; CFG batch order [uncond | text]; the guidance combine
        in fp32, as JAX promotes it against the fp32 guidance scale."""
        scheduler = model.scheduler
        for i in range(plan.num_steps):
            x = torch.cat([latents, latents]) if do_cfg else latents
            x = scheduler.scale_model_input(plan, x, i)
            t = torch.tensor(int(plan.timesteps[i]), device=latents.device)
            pred = model.unet(x, t, embeds)
            if do_cfg:
                uncond, text = pred.float().chunk(2)
                pred = uncond + guidance_scale * (text - uncond)
            latents = scheduler.step(plan, i, pred, latents)
        return latents

    @torch.no_grad()
    def _vae_decode(self, model: SDModel, latents: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> NCHW image in [-1, 1] (unified.py:175-191)."""
        cfg = model.vae_config
        if cfg.latents_mean is not None and cfg.latents_std is not None:
            shape = (1, -1, 1, 1)
            mean = torch.tensor(cfg.latents_mean, device=latents.device).reshape(shape)
            std = torch.tensor(cfg.latents_std, device=latents.device).reshape(shape)
            latents = latents * std / cfg.scaling_factor + mean
        else:
            latents = latents / cfg.scaling_factor
        if self.vae_dtype is not None:
            latents = latents.to(self.vae_dtype)
        elif cfg.force_upcast:
            latents = latents.float()
        return model.vae.decode(latents)

    # -- main entry (unified.py:760) ----------------------------------------
    def __call__(
        self,
        model: SDModel,
        prompt: Union[str, List[str]],
        negative_prompt: Union[str, List[str], None] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_images_per_prompt: int = 1,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: Optional[int] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: Optional[str] = None,
    ) -> SDPipelineOutput:
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, pipeline on {self.device}")
        vf = model.vae_scale_factor
        ucfg = model.unet_config
        height = height or ucfg.sample_size * vf
        width = width or ucfg.sample_size * vf
        B = 1 if isinstance(prompt, str) else len(prompt)
        n = num_images_per_prompt
        do_cfg = self.do_cfg and guidance_scale > 1.0
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))

        embeds, neg_embeds = self.encode_prompt(
            model, prompt, negative_prompt, num_images_per_prompt=n, do_cfg=do_cfg
        )
        embeds = embeds.to(self.dtype)
        if do_cfg:
            embeds = torch.cat([neg_embeds.to(self.dtype), embeds])

        plan = model.scheduler.plan(num_inference_steps)
        c = ucfg.in_channels
        shape = (B * n, height // vf, width // vf, c)
        if latents is None:
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            latents = torch.randn(shape, generator=g, device=self.device)
        else:
            latents = torch.as_tensor(latents, device=self.device)
            if latents.dim() != 4 or latents.shape[-1] != c:
                raise ValueError(
                    f"latents must be NHWC [B, h, w, {c}]; got {tuple(latents.shape)}"
                )
        # provided latents are scaled too (unified.py:1101)
        latents = latents.float() * plan.init_noise_sigma
        latents = latents.permute(0, 3, 1, 2).to(self.dtype)

        latents = self._denoise(model, latents, embeds, plan, float(guidance_scale), do_cfg)

        output_type = output_type or self.output_type
        if output_type == "latents":
            return SDPipelineOutput(None, latents.permute(0, 2, 3, 1), seed)
        if output_type not in ("np", "uint8"):
            raise ValueError(f"output_type {output_type!r}: 'np', 'uint8' or 'latents'")
        images = self._vae_decode(model, latents).permute(0, 2, 3, 1)
        images_np = images.float().cpu().numpy()
        if output_type == "uint8":
            return SDPipelineOutput(img_utils.to_uint8(images_np), None, seed)
        return SDPipelineOutput(img_utils.postprocess_image(images_np), None, seed)
