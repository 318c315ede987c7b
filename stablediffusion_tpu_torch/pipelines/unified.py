"""The unified pipeline: txt2img, img2img and inpainting, SD1.5.

Port of ``stablediffusion_tpu/pipelines/unified.py`` (``__call__``
:760-1330 without its extensions): the mode follows from the inputs (no
image: txt2img; an image: img2img at ``strength``; an image and a mask:
inpainting, ``blend4`` on a 4-channel UNet, ``concat9`` on a 9-channel one,
with ``padding_mask_crop`` and ``masked_image_latents``), CFG with
``guidance_rescale``, clip skip, ``timesteps=`` / ``sigmas=`` schedules,
``denoising_start`` / ``denoising_end`` windows, precomputed prompt
embeddings, the tiled VAE, and ``output_type`` "np", "uint8",
"uint8_device" (uint8 left on the card) or "latents".

The denoise loop is a Python loop over the scheduler's ``step``; latents stay
in the compute dtype between steps, the scheduler state in fp32, as in the
JAX scan.  Random draws come from one ``torch.Generator`` per use site
(latents, VAE encode, step noise, masked-image encode), seeded from the
request's seed; with a seed list, one generator per sample and site, so a
sample's image depends on its own seed only.  The JAX package splits a
``jax.random`` key instead, so the streams differ; parity tests inject the
JAX draws through ``draws=``.

Public layouts are the JAX package's: ``latents`` in and ``output_type=
"latents"`` out are NHWC [B, h, w, 4]; images are NHWC [B, H, W, 3].  The
loop itself runs on NCHW.

Not ported here; each raises and names its ROADMAP §1 item: hires fix,
FreeU, PAG, InstructPix2Pix, DeepCache, ControlNet, IP-Adapter, prompt
weighting and editing (item 15); the SDXL arguments and the refiner (item
13); SD3's (item 18).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import default_dtype, resolve_device
from stablediffusion_tpu_torch.models.vae import tiled_decode, tiled_encode
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.schedulers.common import (
    BaseScheduler,
    Plan,
    resolve_custom_schedule,
    step_noise,
)
from stablediffusion_tpu_torch.utils import images as img_utils


@dataclass
class SDPipelineOutput:
    images: Optional[Union[np.ndarray, torch.Tensor]]  # [B, H, W, 3]: float32
    #   in [0, 1] ("np"), uint8 ("uint8"), a uint8 tensor on the card
    #   ("uint8_device")
    latents: Optional[torch.Tensor]  # NHWC, when output_type="latents"
    seed: Union[int, List[int]]  # echoed; a list when per-sample seeds given


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float) -> torch.Tensor:
    """arXiv 2305.08891 §3.4: rescale the CFG output to the text branch's
    per-sample standard deviation."""
    dims = tuple(range(1, noise_pred_text.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def _denoising_valid(v) -> bool:
    return isinstance(v, float) and 0.0 < v < 1.0


# arguments of the JAX pipeline whose features the port does not have yet:
# name -> (ROADMAP §1 item, whether a value turns the feature on)
_is_set = lambda v: v is not None  # noqa: E731
_UNPORTED = {
    "hires_scale": (15, lambda v: v is not None and float(v) > 1.0),
    "freeu": (15, lambda v: v is not None and v is not False),
    "pag_scale": (15, lambda v: bool(v) and float(v) > 0.0),
    "image_guidance_scale": (15, _is_set),
    "cache_interval": (15, lambda v: bool(v) and int(v) > 1),
    "control_image": (15, _is_set),
    "ip_adapter_image": (15, _is_set),
    "ip_adapter_image_embeds": (15, _is_set),
    "prompt_weighting": (15, bool),
    "prompt_2": (13, _is_set),
    "negative_prompt_2": (13, _is_set),
    "pooled_prompt_embeds": (13, _is_set),
    "negative_pooled_prompt_embeds": (13, _is_set),
    "use_refiner": (13, bool),
    "prompt_3": (18, _is_set),
    "negative_prompt_3": (18, _is_set),
    "max_sequence_length": (18, _is_set),
}
# settings that act only together with an unported feature above
_INERT = ("hires_strength", "hires_steps", "pag_applied_layers",
          "controlnet_conditioning_scale", "ip_adapter_scale")


def _check_unported(kwargs: dict) -> None:
    for name, value in kwargs.items():
        if name in _UNPORTED:
            item, active = _UNPORTED[name]
            if active(value):
                raise NotImplementedError(
                    f"{name}={value!r}: not ported yet, it comes with ROADMAP §1 item {item}")
        elif name not in _INERT:
            raise TypeError(f"unexpected keyword argument {name!r}")


def _seed_of(seed: int, site: int) -> int:
    """A 64-bit generator seed for one (request seed, use site) pair."""
    return int(np.random.SeedSequence([int(seed) % 2**63, site]).generate_state(1, np.uint64)[0])


class _Draws:
    """Where each random draw of one call comes from: a ``torch.Generator``
    per use site (one per sample and site with a seed list), or arrays
    injected through ``draws=`` (NHWC; "steps" is [N, B, h, w, c])."""

    SITES = {"latents": 0, "encode": 1, "steps": 2, "encode_masked": 3}

    def __init__(self, seed, device: torch.device, injected: Optional[Dict] = None):
        self.seed_list = list(seed) if isinstance(seed, list) else None
        self.seed = self.seed_list[0] if self.seed_list else seed
        self.device = device
        self.injected = dict(injected or {})
        unknown = set(self.injected) - set(self.SITES)
        if unknown:
            raise ValueError(f"draws: unknown sites {sorted(unknown)}")
        self._gens: Dict[Tuple[str, bool], object] = {}

    def generator(self, site: str, batch: int):
        """The site's generator, or its per-sample generators when a seed
        list of this batch size was given (others share one, as the JAX
        pipeline's `_psk` falls back to the shared key)."""
        per_sample = self.seed_list is not None and batch == len(self.seed_list)
        key = (site, per_sample)
        if key not in self._gens:
            mk = lambda s: torch.Generator(device=self.device).manual_seed(  # noqa: E731
                _seed_of(s, self.SITES[site]))
            self._gens[key] = [mk(s) for s in self.seed_list] if per_sample else mk(self.seed)
        return self._gens[key]

    def _injected(self, site: str, shape, index=None) -> Optional[torch.Tensor]:
        if site not in self.injected:
            return None
        x = torch.as_tensor(self.injected[site])
        if index is not None:
            x = x[index]
        x = x.to(self.device, torch.float32).permute(0, 3, 1, 2)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"draws[{site!r}]: NCHW {tuple(x.shape)}, want {tuple(shape)}")
        return x

    def randn(self, site: str, like: torch.Tensor) -> torch.Tensor:
        """Standard normal fp32 noise of `like`'s NCHW shape."""
        x = self._injected(site, like.shape)
        return x if x is not None else step_noise(self.generator(site, like.shape[0]), like)

    def step(self, i: int, like: torch.Tensor) -> torch.Tensor:
        x = self._injected("steps", like.shape, index=i)
        return x if x is not None else step_noise(self.generator("steps", like.shape[0]), like)


class StableDiffusionUnifiedPipeline:
    """txt2img / img2img / inpaint on one device: ``cuda`` unless
    `device="cpu"` is passed."""

    def __init__(
        self,
        do_cfg: bool = True,
        output_type: str = "np",  # "np" | "uint8" | "uint8_device" | "latents"
        dtype: Optional[torch.dtype] = None,  # default: bf16 on cuda, fp32 on cpu
        vae_dtype: Optional[torch.dtype] = None,  # overrides force_upcast
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        self.do_cfg = do_cfg
        self.output_type = output_type
        self.dtype = dtype or default_dtype(self.device)
        self.vae_dtype = vae_dtype

    # -- prompt encoding (unified.py:438-587, SD1.5) ------------------------
    @torch.no_grad()
    def _clip_encode(self, model: SDModel, texts: List[str],
                     clip_skip: Optional[int] = None) -> torch.Tensor:
        """Mode "last", or "skip_renorm" with a clip skip: the hidden state
        `clip_skip` layers before the last, through final_layer_norm."""
        ids = torch.from_numpy(model.tokenizer(texts)).to(self.device)
        out = model.text_encoder(ids)
        if clip_skip:
            return model.text_encoder.final_layer_norm(out.hidden_states[-(clip_skip + 1)])
        return out.last_hidden_state

    def encode_prompt(
        self,
        model: SDModel,
        prompt: Union[str, List[str]],
        negative_prompt: Union[str, List[str], None] = None,
        num_images_per_prompt: int = 1,
        do_cfg: bool = True,
        clip_skip: Optional[int] = None,
    ):
        """-> (embeds, neg_embeds or None), each [B * n, 77, D].  The clip
        skip applies to the prompts, not to the negatives, as in JAX."""
        prompt = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompt)
        embeds = self._clip_encode(model, prompt, clip_skip)
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
        tile = lambda x: x.repeat_interleave(n, dim=0) if x is not None else None  # noqa: E731
        return tile(embeds), tile(neg_embeds)

    # -- timestep windows (unified.py:626-704) -------------------------------
    def get_timesteps(self, scheduler: BaseScheduler, num_inference_steps: int,
                      strength: float, denoising_start: Optional[float],
                      timesteps=None, sigmas=None) -> Tuple[Plan, int]:
        plan = scheduler.plan(num_inference_steps, timesteps=timesteps, sigmas=sigmas)
        if denoising_start is None:
            # order-2 plans (Heun) spend two indices per sampler step
            base_steps = -(-plan.num_steps // plan.order)
            t_start = max(base_steps - int(num_inference_steps * strength), 0) * plan.order
        else:
            T = scheduler.config.num_train_timesteps
            cutoff = int(round(T - denoising_start * T))
            keep = int((plan.timesteps < cutoff).sum())
            if plan.order == 2 and keep % 2 == 0:
                keep = min(keep + 1, plan.num_steps)  # start on a predictor
            t_start = plan.num_steps - keep
        if t_start > 0:
            plan = self._slice_plan(plan, t_start)
        if plan.num_steps < 1:
            raise ValueError(f"strength {strength} leaves {plan.num_steps} steps (<1)")
        return plan, t_start

    @staticmethod
    def _slice_plan(plan: Plan, t_start: int) -> Plan:
        """The plan from index t_start on; step_ratio stays the full grid's."""
        return replace(plan, timesteps=plan.timesteps[t_start:],
                       sigmas=plan.sigmas[t_start:], num_steps=plan.num_steps - t_start)

    @staticmethod
    def _apply_denoising_end(plan: Plan, scheduler: BaseScheduler,
                             denoising_end: float) -> Plan:
        T = scheduler.config.num_train_timesteps
        cutoff = int(round(T - denoising_end * T))
        keep = int((plan.timesteps >= cutoff).sum())
        return replace(plan, timesteps=plan.timesteps[:keep],
                       sigmas=plan.sigmas[: keep + 1], num_steps=keep)

    # -- stages ---------------------------------------------------------------
    @torch.no_grad()
    def _vae_encode(self, model: SDModel, image_nhwc: np.ndarray, draws: _Draws,
                    site: str, tiling: bool) -> torch.Tensor:
        """NHWC pixels in [-1, 1] -> NCHW latents sampled from the encoder's
        distribution and scaled (unified.py:110-150)."""
        x = torch.as_tensor(np.asarray(image_nhwc), device=self.device).permute(0, 3, 1, 2)
        if model.vae_config.force_upcast:
            x = x.float()
        else:
            x = x.to(next(model.vae.parameters()).dtype)
        mean, logvar = tiled_encode(model.vae, x) if tiling else model.vae.encode(x)
        eps = draws.randn(site, mean).to(mean.dtype)
        z = mean + torch.exp(0.5 * logvar) * eps
        return z * model.vae_config.scaling_factor

    @torch.no_grad()
    def _denoise(self, model: SDModel, latents: torch.Tensor, embeds: torch.Tensor,
                 plan: Plan, draws: _Draws, guidance_scale: float,
                 guidance_rescale: float, do_cfg: bool, inpaint_mode: str = "none",
                 mask: Optional[torch.Tensor] = None,
                 masked_image_latents: Optional[torch.Tensor] = None,
                 image_latents: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The hot loop (unified.py:209-400 without its extensions): latents
        NCHW in the compute dtype; CFG batch order [uncond | text]; the
        guidance combine in fp32."""
        scheduler = model.scheduler
        N = plan.num_steps
        state = scheduler.init_state(plan, latents.shape, latents.device)
        if inpaint_mode == "concat9":
            m = torch.cat([mask, mask]) if do_cfg else mask
            mi = torch.cat([masked_image_latents] * 2) if do_cfg else masked_image_latents
        for i in range(N):
            x = torch.cat([latents, latents]) if do_cfg else latents
            x = scheduler.scale_model_input(plan, x, i)
            if inpaint_mode == "concat9":
                x = torch.cat([x, m.to(x.dtype), mi.to(x.dtype)], dim=1)
            t = torch.tensor(plan.timesteps[i], device=latents.device)
            pred = model.unet(x, t, embeds)
            if do_cfg:
                uncond, text = pred.float().chunk(2)
                pred = uncond + guidance_scale * (text - uncond)
                if guidance_rescale > 0.0:
                    pred = rescale_noise_cfg(pred, text, guidance_rescale)
            step_noise_i = draws.step(i, latents) if scheduler.uses_noise() else None
            latents, state = scheduler.step(plan, state, i, pred, latents, noise=step_noise_i)
            if inpaint_mode == "blend4":
                # the known region follows the image, re-noised to the next
                # step's level (add_noise at i + 1)
                init_prop = (scheduler.add_noise_index(plan, image_latents, noise, i + 1)
                             if i < N - 1 else image_latents)
                mk = mask.to(latents.dtype)
                latents = (1.0 - mk) * init_prop.to(latents.dtype) + mk * latents
        return latents

    @torch.no_grad()
    def _vae_decode(self, model: SDModel, latents: torch.Tensor,
                    tiling: bool = False) -> torch.Tensor:
        """NCHW latents -> NCHW image in [-1, 1] (unified.py:175-191); the
        tiled decode under `tiling`."""
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
        return tiled_decode(model.vae, latents) if tiling else model.vae.decode(latents)

    # -- main entry (unified.py:760) ----------------------------------------
    def __call__(
        self,
        model: SDModel,
        prompt: Union[str, List[str], None] = None,
        negative_prompt: Union[str, List[str], None] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_images_per_prompt: int = 1,
        num_inference_steps: int = 50,
        timesteps=None,
        sigmas=None,
        denoising_start: Optional[float] = None,
        denoising_end: Optional[float] = None,
        guidance_scale: float = 5.0,
        guidance_rescale: float = 0.0,
        cross_attention_kwargs: Optional[dict] = None,  # LoRA scale: no adapters here
        clip_skip: Optional[int] = None,
        seed: Union[int, List[int], None] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: Optional[str] = None,
        image=None,
        strength: float = 1.0,
        mask_image=None,
        masked_image_latents=None,
        padding_mask_crop: Optional[int] = None,
        vae_tiling: bool = False,
        prompt_embeds=None,
        negative_prompt_embeds=None,
        draws: Optional[Dict[str, np.ndarray]] = None,
        **extensions,
    ) -> SDPipelineOutput:
        """`draws` injects the random draws (NHWC arrays by use site:
        "latents", "encode", "encode_masked", and "steps" [N, B, h, w, c])
        in place of the generators, as the train step takes ``draws=``."""
        _check_unported(extensions)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, pipeline on {self.device}")
        ucfg = model.unet_config
        if ucfg.in_channels == 8:
            raise NotImplementedError(
                "an 8-channel (InstructPix2Pix) UNet: not ported yet, it comes with "
                "ROADMAP §1 item 15")
        scheduler = model.scheduler
        num_inference_steps = resolve_custom_schedule(num_inference_steps, timesteps, sigmas)
        vf = model.vae_scale_factor
        height = height or ucfg.sample_size * vf
        width = width or ucfg.sample_size * vf
        if prompt is None and prompt_embeds is None:
            raise ValueError("prompt or prompt_embeds is required")
        if prompt_embeds is not None:
            B = prompt_embeds.shape[0]
        else:
            B = 1 if isinstance(prompt, str) else len(prompt)
        n = num_images_per_prompt
        do_cfg = self.do_cfg and guidance_scale > 1.0

        # seed: an int, or one per sample
        if isinstance(seed, (list, tuple)):
            seed = [int(s) for s in seed]
            if len(seed) != B * n:
                raise ValueError(f"seed list length {len(seed)} != batch {B * n}")
        elif seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        rng = _Draws(seed, self.device, draws)

        # prompts
        if prompt_embeds is not None:
            embeds = torch.as_tensor(prompt_embeds, device=self.device)
            neg_embeds = (
                torch.as_tensor(negative_prompt_embeds, device=self.device)
                if negative_prompt_embeds is not None
                else (torch.zeros_like(embeds) if do_cfg else None)
            )
            embeds = embeds.repeat_interleave(n, dim=0)
            if neg_embeds is not None:
                neg_embeds = neg_embeds.repeat_interleave(n, dim=0)
        else:
            embeds, neg_embeds = self.encode_prompt(
                model, prompt, negative_prompt, num_images_per_prompt=n, do_cfg=do_cfg,
                clip_skip=clip_skip)
        embeds = embeds.to(self.dtype)

        lat_c = model.vae_config.latent_channels
        unet_c = ucfg.in_channels
        inpaint_mode = "none"
        mask_lat = masked_lat = image_lat = noise4 = None
        crop = original_image_np = mask_np = None
        start = denoising_start if _denoising_valid(denoising_start) else None

        if image is None:  # txt2img
            plan = scheduler.plan(num_inference_steps, timesteps=timesteps, sigmas=sigmas)
            if start is not None:
                plan, _ = self.get_timesteps(scheduler, num_inference_steps, 1.0, start,
                                             timesteps=timesteps, sigmas=sigmas)
            shape = (B * n, unet_c, height // vf, width // vf)
            if latents is None:
                latents = rng.randn("latents", torch.empty(shape, device=self.device))
            else:
                latents = self._to_nchw(latents, unet_c).float()
            # given latents are scaled too (unified.py:1101)
            latents = latents * plan.init_noise_sigma
        elif mask_image is None:  # img2img
            image_arr = self._image_or_latents(image, lat_c)
            plan, _ = self.get_timesteps(scheduler, num_inference_steps, strength, start,
                                         timesteps=timesteps, sigmas=sigmas)
            if getattr(image_arr, "ndim", 0) == 4 and image_arr.shape[-1] == lat_c:
                init_latents = self._to_nchw(image_arr, lat_c)
            else:
                init_latents = self._vae_encode(
                    model, img_utils.preprocess_image(image_arr, height, width), rng,
                    "encode", vae_tiling)
            init_latents = init_latents.repeat(B * n // init_latents.shape[0], 1, 1, 1)
            if denoising_start is None:
                noise = rng.randn("latents", init_latents)
                latents = scheduler.add_noise_index(plan, init_latents.float(), noise, 0)
            else:
                latents = init_latents
            height, width = latents.shape[2] * vf, latents.shape[3] * vf
        else:  # inpaint
            if padding_mask_crop is not None:
                mask_np = img_utils.preprocess_mask(mask_image, height, width)
                crop = img_utils.get_crop_region(mask_np[0], width, height,
                                                 pad=padding_mask_crop)
                x1, y1, x2, y2 = crop
                original_image_np = img_utils.postprocess_image(
                    img_utils.preprocess_image(image, height, width))[0]
                image = original_image_np[y1:y2, x1:x2]
                mask_image = mask_np[0, y1:y2, x1:x2]
            init_image = img_utils.preprocess_image(image, height, width)
            mask_np = img_utils.preprocess_mask(mask_image, height, width)
            plan, _ = self.get_timesteps(scheduler, num_inference_steps, strength, start,
                                         timesteps=timesteps, sigmas=sigmas)
            if unet_c == 9:
                inpaint_mode = "concat9"
            elif unet_c == 4:
                inpaint_mode = "blend4"
            else:
                raise ValueError(f"inpaint UNet must have 4 or 9 channels, got {unet_c}")
            image_lat = self._vae_encode(model, init_image, rng, "encode", vae_tiling)
            image_lat = image_lat.repeat(B * n // image_lat.shape[0], 1, 1, 1)
            shape = (B * n, lat_c, height // vf, width // vf)
            noise4 = rng.randn("latents", torch.empty(shape, device=self.device))
            if latents is not None:
                # given latents act as the noise, scaled
                noise4 = self._to_nchw(latents, lat_c).float()
                latents = noise4 * plan.init_noise_sigma
            elif strength == 1.0:
                latents = noise4 * plan.init_noise_sigma
            elif denoising_start is None:
                latents = scheduler.add_noise_index(plan, image_lat.float(), noise4, 0)
            else:
                latents = image_lat
            mask_small = img_utils.preprocess_mask(mask_np, height // vf, width // vf)
            mask_lat = torch.from_numpy(mask_small).to(self.device).permute(0, 3, 1, 2)
            mask_lat = mask_lat.repeat(B * n, 1, 1, 1)
            if masked_image_latents is not None:
                masked_lat = self._to_nchw(masked_image_latents, lat_c)
            elif inpaint_mode == "concat9":
                masked_lat = self._vae_encode(model, init_image * (mask_np < 0.5), rng,
                                              "encode_masked", vae_tiling)
                masked_lat = masked_lat.repeat(B * n // masked_lat.shape[0], 1, 1, 1)

        if denoising_end is not None and _denoising_valid(denoising_end):
            if start is not None and denoising_start >= denoising_end:
                raise ValueError(
                    f"denoising_start {denoising_start} >= denoising_end {denoising_end}")
            plan = self._apply_denoising_end(plan, scheduler, denoising_end)

        if do_cfg:
            embeds = torch.cat([neg_embeds.to(self.dtype), embeds])
        latents = self._denoise(
            model, latents.to(self.dtype), embeds, plan, rng, float(guidance_scale),
            float(guidance_rescale), do_cfg, inpaint_mode, mask_lat, masked_lat,
            image_lat, noise4)

        output_type = output_type or self.output_type
        if output_type == "pt":
            output_type = "np"
        if output_type == "latents":
            return SDPipelineOutput(None, latents.permute(0, 2, 3, 1), seed)
        if output_type not in ("np", "uint8", "uint8_device"):
            raise ValueError(
                f"output_type {output_type!r}: 'np', 'uint8', 'uint8_device' or 'latents'")
        images = self._vae_decode(model, latents, tiling=vae_tiling).permute(0, 2, 3, 1)
        if output_type in ("uint8", "uint8_device") and crop is None:
            dev = img_utils.postprocess_uint8_device(images)
            if output_type == "uint8_device":
                return SDPipelineOutput(dev, None, seed)
            return SDPipelineOutput(dev.cpu().numpy(), None, seed)
        images_np = img_utils.postprocess_image(images.float().cpu().numpy())
        if crop is not None:
            images_np = np.stack([
                img_utils.apply_overlay(original_image_np, im, mask_np[0], crop)
                for im in images_np
            ])
        if output_type in ("uint8", "uint8_device"):
            images_np = (images_np * 255).round().astype(np.uint8)
        return SDPipelineOutput(images_np, None, seed)

    # -- helpers -------------------------------------------------------------
    def _to_nchw(self, x, channels: int) -> torch.Tensor:
        """NHWC or NCHW latents -> an NCHW tensor on the pipeline's device."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            device=self.device)
        if x.dim() == 4 and x.shape[-1] == channels:
            return x.permute(0, 3, 1, 2)
        if x.dim() == 4 and x.shape[1] == channels:
            return x
        raise ValueError(f"cannot interpret latents of shape {tuple(x.shape)}")

    @staticmethod
    def _image_or_latents(image, lat_c: int):
        """Latent-shaped input (NHWC or NCHW with `lat_c` channels) goes to
        NHWC and skips the encoder; anything else is an image."""
        arr = image if hasattr(image, "shape") else np.asarray(image)
        if getattr(arr, "ndim", 0) == 4 and (arr.shape[-1] == lat_c or arr.shape[1] == lat_c):
            if arr.shape[1] == lat_c and arr.shape[-1] != lat_c:
                arr = np.transpose(np.asarray(arr), (0, 2, 3, 1))
            return arr
        return image
