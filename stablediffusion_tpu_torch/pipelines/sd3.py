"""StableDiffusion3Pipeline: MM-DiT txt2img, img2img and inpainting.

Port of ``stablediffusion_tpu/pipelines/sd3.py``: ``SD3Model`` (:39-117,
the holder) and ``StableDiffusion3Pipeline`` (:366-709).  The prompts go
through three towers (:412-470): the penultimate hidden states of CLIP-L and
bigG, concatenated on the channel axis and zero-padded to the MM-DiT's
``joint_attention_dim``, then T5's last hidden state at
``max_sequence_length`` tokens appended on the sequence axis (zeros in its
place when the model has no ``text_encoder_3``, the T5-free serving mode);
the pooled embedding is the two CLIP towers' projected pooled outputs,
concatenated.  ``prompt_2`` / ``prompt_3`` and the negatives default as in
JAX, and the clip skip applies to every encode.  The denoise is the
flow-match Euler loop with CFG (:262-320); img2img slices the plan at
``strength`` (:633), inpainting blends the kept region back at the next
step's sigma (:297-315).  The 16-channel VAE's latents carry a shift as well
as a scale (``models/vae.normalize_latents``).

Random draws come from ``torch.Generator``s per use site, one per sample and
site with a seed list (``pipelines/unified._Draws``), so a sample's image
depends on its own seed only; parity tests inject the JAX draws through
``draws=``.  Public layouts are the JAX package's: ``latents`` in and
``output_type="latents"`` out are NHWC, images NHWC.

LoRA adapters go on the MM-DiT and both CLIP towers, never on T5, and int8
quantization on the MM-DiT (:98-255), through the lifecycle ``SDModel``
shares (``models/wrapper.AdapterHolder``); LoRA files resolve as
``{lora_dir}/sd3_{name}.safetensors``.

``prompt_weighting`` (:400-450, :556-590) weights the CLIP towers' tokens
(one 77-token window each; T5 reads the text without the markup) and turns
on ``[from:to:when]`` / ``[a|b]`` prompt editing: the embeddings of the
unique realised prompts are stacked and the loop picks one by step, the
boundaries shifted by img2img's skipped steps; pooled embeds stay at the
first variant.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from stablediffusion_tpu_torch.core.config import (
    CLIPTextConfig,
    SchedulerConfig,
    SD3Config,
    VAEConfig,
    default_dtype,
    resolve_device,
)
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel
from stablediffusion_tpu_torch.models.t5 import T5Config, T5EncoderModel
from stablediffusion_tpu_torch.models.wrapper import AdapterHolder
from stablediffusion_tpu_torch.models.vae import (
    AutoencoderKL,
    denormalize_latents,
    normalize_latents,
    sample_latent,
    tiled_decode,
    tiled_encode,
)
from stablediffusion_tpu_torch.pipelines.unified import (
    SDPipelineOutput,
    StableDiffusionUnifiedPipeline,
    _Draws,
    clip_encode,
    embeds_at,
    to_nchw,
)
from stablediffusion_tpu_torch.schedulers import make_scheduler
from stablediffusion_tpu_torch.schedulers.common import Plan, resolve_custom_schedule
from stablediffusion_tpu_torch.utils import images as img_utils
from stablediffusion_tpu_torch.utils import prompt_edit as pe
from stablediffusion_tpu_torch.utils import prompt_weights as pw


@dataclass
class SD3Model(AdapterHolder):
    """Configs, modules and tokenizers of one SD3-family model, all on one
    device.  ``text_encoder_3`` (T5) and its tokenizer are optional: SD3
    serves without them (the T5-free mode)."""

    TOWER = "transformer"
    # the AdaLN modulation linears sit under norm* paths, the conditioning
    # embedders and the patch projection are input boundaries, proj_out (the
    # pixel head alone: the attention blocks use to_out / to_add_out) the
    # output boundary
    _QUANT_SKIP = ("norm", "embedder", "pos_embed", "proj_out")

    transformer_config: SD3Config
    transformer: SD3Transformer2DModel
    vae_config: VAEConfig
    vae: AutoencoderKL
    # CLIP-L, with a projection in SD3 layouts
    text_encoder_config: CLIPTextConfig
    text_encoder: CLIPTextModel
    tokenizer: Any
    # CLIP-bigG
    text_encoder_2_config: CLIPTextConfig
    text_encoder_2: CLIPTextModel
    tokenizer_2: Any
    # T5-XXL
    text_encoder_3_config: Optional[T5Config] = None
    text_encoder_3: Optional[T5EncoderModel] = None
    tokenizer_3: Any = None
    scheduler_config: SchedulerConfig = field(default_factory=SchedulerConfig)
    scheduler_name: str = "FlowMatchEuler"
    path: Optional[str] = None
    model_type: str = "sd3"

    _scheduler: Optional[Any] = field(default=None, repr=False)

    def __post_init__(self):
        modules = (self.transformer, self.vae, self.text_encoder, self.text_encoder_2,
                   self.text_encoder_3)
        devices = {p.device for m in modules if m is not None for p in m.parameters()}
        if len(devices) != 1:
            raise ValueError(f"SD3Model modules span devices {sorted(map(str, devices))}")

    @property
    def device(self) -> torch.device:
        return next(self.transformer.parameters()).device

    @property
    def vae_scale_factor(self) -> int:
        return self.vae_config.vae_scale_factor

    @property
    def joint_dim(self) -> int:
        return self.transformer_config.joint_attention_dim

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

    def _lora_modules(self) -> Dict[str, torch.nn.Module]:
        return {"transformer": self.transformer, "text_encoder": self.text_encoder,
                "text_encoder_2": self.text_encoder_2}


class StableDiffusion3Pipeline:
    """txt2img / img2img / inpaint of an :class:`SD3Model` on one device:
    ``cuda`` unless `device="cpu"` is passed."""

    def __init__(
        self,
        do_cfg: bool = True,
        output_type: str = "np",  # "np" | "uint8" | "uint8_device" | "latents"
        dtype: Optional[torch.dtype] = None,  # default: bf16 on cuda, fp32 on cpu
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        self.do_cfg = do_cfg
        self.output_type = output_type
        self.dtype = dtype or default_dtype(self.device)

    # -- prompt encoding (sd3.py:412-470) -------------------------------------
    @torch.no_grad()
    def encode_prompt(
        self,
        model: SD3Model,
        prompt: Union[str, List[str]],
        prompt_2=None,
        prompt_3=None,
        negative_prompt=None,
        negative_prompt_2=None,
        negative_prompt_3=None,
        num_images_per_prompt: int = 1,
        do_cfg: bool = True,
        max_sequence_length: int = 256,
        clip_skip: Optional[int] = None,
        prompt_weighting: bool = False,
    ):
        """-> (embeds [B*n, 77 + max_sequence_length, joint_dim], neg_embeds,
        pooled [B*n, P1 + P2], neg_pooled), the negatives None without
        CFG.  `prompt_weighting` weights the CLIP tokens and hands T5 the
        text without the markup."""
        prompt = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompt)

        def listify(p, fallback):
            p = p if p is not None else fallback
            p = [p] if isinstance(p, str) else list(p)
            return p * B if len(p) == 1 and B > 1 else p

        def clip_embed(texts, tok, encoder):
            ids = weights = None
            if prompt_weighting:
                ids, w = pw.encode_with_weights(tok, texts)
                weights = w if (w != 1.0).any() else None
            h, pooled = clip_encode(tok, encoder, texts, "penultimate", self.device,
                                    clip_skip or 0, ids=ids)
            if weights is not None:
                h = pw.apply_token_weights(h, weights)
            return h, pooled

        def encode_all(p1, p2, p3):
            h1, pool1 = clip_embed(p1, model.tokenizer, model.text_encoder)
            h2, pool2 = clip_embed(p2, model.tokenizer_2, model.text_encoder_2)
            clip_h = torch.cat([h1, h2.to(h1.dtype)], dim=-1)
            clip_h = F.pad(clip_h, (0, model.joint_dim - clip_h.shape[-1]))
            if model.text_encoder_3 is not None:
                if prompt_weighting:  # T5 takes no token weights
                    p3 = [pw.strip_weight_markup(t) for t in p3]
                ids = np.asarray(model.tokenizer_3(p3, max_length=max_sequence_length))
                t5_h = model.text_encoder_3(torch.from_numpy(ids).long().to(self.device))
            else:  # T5 dropped: zeros, as diffusers does
                t5_h = clip_h.new_zeros((len(p1), max_sequence_length, model.joint_dim))
            embeds = torch.cat([clip_h, t5_h.to(clip_h.dtype)], dim=1)
            return embeds, torch.cat([pool1, pool2.to(pool1.dtype)], dim=-1)

        embeds, pooled = encode_all(prompt, listify(prompt_2, prompt), listify(prompt_3, prompt))
        neg_embeds = neg_pooled = None
        if do_cfg:
            neg = listify(negative_prompt, "")
            neg_embeds, neg_pooled = encode_all(
                neg, listify(negative_prompt_2, neg), listify(negative_prompt_3, neg))
        n = num_images_per_prompt
        tile = lambda x: x.repeat_interleave(n, dim=0) if x is not None else None  # noqa: E731
        return tile(embeds), tile(neg_embeds), tile(pooled), tile(neg_pooled)

    # -- stages ----------------------------------------------------------------
    @torch.no_grad()
    def _vae_encode(self, model: SD3Model, image_nhwc: np.ndarray, draws: _Draws,
                    tiling: bool) -> torch.Tensor:
        """NHWC pixels in [-1, 1] -> NCHW latents sampled from the encoder's
        distribution in fp32 and normalised (sd3.py:329-355)."""
        x = torch.as_tensor(np.asarray(image_nhwc), device=self.device)
        x = x.permute(0, 3, 1, 2).float()
        mean, logvar = tiled_encode(model.vae, x) if tiling else model.vae.encode(x)
        z = sample_latent(mean, logvar, eps=draws.randn("encode", mean))
        return normalize_latents(z, model.vae_config)

    @torch.no_grad()
    def _denoise(self, model: SD3Model, latents: torch.Tensor, embeds,
                 pooled: torch.Tensor, plan: Plan, draws: _Draws, guidance_scale: float,
                 do_cfg: bool, mask: Optional[torch.Tensor] = None,
                 image_latents: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The flow-match loop (sd3.py:262-320): CFG batch order [uncond |
        text], the guidance combine in fp32; with a mask, the kept region
        follows the image re-noised to the next step's sigma.  Under prompt
        editing `embeds` is a (stack, starts, idx_map) triple, the starts in
        local step units."""
        scheduler = model.scheduler
        N = plan.num_steps
        state = scheduler.init_state(plan, latents.shape, latents.device)
        for i in range(N):
            x = torch.cat([latents, latents]) if do_cfg else latents
            pred = model.transformer(x, plan.timesteps[i], embeds_at(embeds, i), pooled)
            if do_cfg:
                uncond, text = pred.float().chunk(2)
                pred = uncond + guidance_scale * (text - uncond)
            step_noise = draws.step(i, latents) if scheduler.uses_noise() else None
            latents, state = scheduler.step(plan, state, i, pred, latents, noise=step_noise)
            if mask is not None:
                init_prop = (scheduler.add_noise_index(plan, image_latents, noise, i + 1)
                             if i < N - 1 else image_latents)
                m = mask.to(latents.dtype)
                latents = (1.0 - m) * init_prop.to(latents.dtype) + m * latents
        return latents

    @torch.no_grad()
    def _vae_decode(self, model: SD3Model, latents: torch.Tensor, tiling: bool) -> torch.Tensor:
        """NCHW latents -> NCHW image in [-1, 1], in fp32 (sd3.py:323-327)."""
        z = denormalize_latents(latents.float(), model.vae_config)
        return tiled_decode(model.vae, z) if tiling else model.vae.decode(z)

    # -- main entry (sd3.py:474) --------------------------------------------------
    @torch.no_grad()
    def __call__(
        self,
        model: SD3Model,
        prompt: Union[str, List[str]] = None,
        prompt_2=None,
        prompt_3=None,
        negative_prompt=None,
        negative_prompt_2=None,
        negative_prompt_3=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 7.0,
        num_images_per_prompt: int = 1,
        seed: Union[int, List[int], None] = None,
        latents=None,
        max_sequence_length: int = 256,
        clip_skip: Optional[int] = None,
        output_type: Optional[str] = None,
        image=None,
        strength: float = 0.6,
        mask_image=None,
        timesteps=None,
        sigmas=None,
        vae_tiling: bool = False,
        prompt_weighting: bool = False,
        draws: Optional[Dict[str, np.ndarray]] = None,
    ) -> SDPipelineOutput:
        """`draws` injects the random draws (NHWC arrays by use site:
        "latents" (the initial latents, or the noise added to the image),
        "encode" (the VAE encode's sampling noise), "steps" for a scheduler
        that draws step noise) in place of the generators."""
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, pipeline on {self.device}")
        if prompt is None:
            raise ValueError("prompt is required")
        scheduler = model.scheduler
        num_inference_steps = resolve_custom_schedule(num_inference_steps, timesteps, sigmas)
        vf = model.vae_scale_factor
        height = height or model.transformer_config.sample_size * vf
        width = width or model.transformer_config.sample_size * vf
        B = 1 if isinstance(prompt, str) else len(prompt)
        n = num_images_per_prompt
        do_cfg = self.do_cfg and guidance_scale > 1.0

        # seed: an int, or one per sample (sample i's noise from seed i alone)
        if isinstance(seed, (list, tuple)):
            seed = [int(s) for s in seed]
            if len(seed) != B * n:
                raise ValueError(f"seed list length {len(seed)} != batch size {B * n}")
        elif seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        rng = _Draws(seed, self.device, draws)

        # prompt editing and alternation: the unique realised prompts, each
        # encoded once (fixed-length embeds, so no chunk floor)
        edit_starts = edit_uniq = edit_idx_map = None
        enc_prompt = prompt
        if prompt_weighting:
            texts = [prompt] if isinstance(prompt, str) else list(prompt)
            merged = pe.schedule_prompts(texts, num_inference_steps)
            if merged is not None and len(merged[0]) > 1:
                edit_starts = merged[0]
                edit_uniq, edit_idx_map = pe.unique_variants(merged[1])
                enc_prompt = edit_uniq[0]
            elif merged is not None:
                enc_prompt = merged[1][0]
        enc = dict(num_images_per_prompt=n, max_sequence_length=max_sequence_length,
                   clip_skip=clip_skip, prompt_weighting=prompt_weighting)
        embeds, neg_embeds, pooled, neg_pooled = self.encode_prompt(
            model, enc_prompt, prompt_2, prompt_3, negative_prompt, negative_prompt_2,
            negative_prompt_3, do_cfg=do_cfg, **enc)
        if do_cfg:
            embeds = torch.cat([neg_embeds, embeds])
            pooled = torch.cat([neg_pooled, pooled])
        embeds, pooled = embeds.to(self.dtype), pooled.to(self.dtype)
        if edit_starts is not None:
            full = [embeds]
            for v in edit_uniq[1:]:
                e = self.encode_prompt(model, v, prompt_2, prompt_3, None, None, None,
                                       do_cfg=False, **enc)[0].to(self.dtype)
                full.append(torch.cat([neg_embeds.to(self.dtype), e]) if do_cfg else e)
            embeds = (torch.stack(full), list(edit_starts), list(edit_idx_map))

        lat_c = model.vae_config.latent_channels
        if mask_image is not None and image is None:
            raise ValueError("inpaint needs both image and mask_image")
        plan = scheduler.plan(num_inference_steps, timesteps=timesteps, sigmas=sigmas)
        mask_lat = image_lat = noise = None
        if image is None:
            if latents is None:
                shape = (B * n, lat_c, height // vf, width // vf)
                latents = rng.randn("latents", torch.empty(shape, device=self.device))
            else:
                # flow matching starts from the noise itself: given latents
                # are not scaled (sd3.py:609-616)
                latents = to_nchw(latents, lat_c, self.device).float()
        else:
            t_start = min(max(int(plan.num_steps * (1.0 - strength)), 0), plan.num_steps - 1)
            if isinstance(embeds, tuple):  # edit boundaries in the sliced plan's steps
                embeds = (embeds[0], [s0 - t_start for s0 in embeds[1]], embeds[2])
            plan = StableDiffusionUnifiedPipeline._slice_plan(plan, t_start)
            pixels = img_utils.preprocess_image(image, height, width)
            init_lat = self._vae_encode(model, pixels, rng, vae_tiling)
            init_lat = init_lat.repeat(B * n // init_lat.shape[0], 1, 1, 1)
            noise = rng.randn("latents", init_lat)
            latents = scheduler.add_noise_index(plan, init_lat, noise, 0)
            if mask_image is not None:
                small = img_utils.preprocess_mask(mask_image, height // vf, width // vf)
                mask_lat = torch.from_numpy(small).to(self.device).permute(0, 3, 1, 2)
                mask_lat = mask_lat.repeat(B * n, 1, 1, 1)
                image_lat = init_lat

        latents = self._denoise(model, latents.to(self.dtype), embeds, pooled, plan, rng,
                                float(guidance_scale), do_cfg, mask_lat, image_lat, noise)

        output_type = output_type or self.output_type
        if output_type == "latents":
            return SDPipelineOutput(None, latents.permute(0, 2, 3, 1), seed)
        if output_type not in ("np", "uint8", "uint8_device"):
            raise ValueError(
                f"output_type {output_type!r}: 'np', 'uint8', 'uint8_device' or 'latents'")
        images = self._vae_decode(model, latents, vae_tiling).permute(0, 2, 3, 1)
        if output_type in ("uint8", "uint8_device"):
            dev = img_utils.postprocess_uint8_device(images)
            if output_type == "uint8_device":
                return SDPipelineOutput(dev, None, seed)
            return SDPipelineOutput(dev.cpu().numpy(), None, seed)
        return SDPipelineOutput(img_utils.postprocess_image(images.float().cpu().numpy()),
                                None, seed)
