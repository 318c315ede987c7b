"""The unified pipeline: txt2img, img2img and inpainting, SD1.x/2.x and SDXL.

Port of ``stablediffusion_tpu/pipelines/unified.py`` (``__call__``
:760-1330 without its extensions): the mode follows from the inputs (no
image: txt2img; an image: img2img at ``strength``; an image and a mask:
inpainting, ``blend4`` on a 4-channel UNet, ``concat9`` on a 9-channel one,
with ``padding_mask_crop`` and ``masked_image_latents``), CFG with
``guidance_rescale``, clip skip, ``timesteps=`` / ``sigmas=`` schedules,
``denoising_start`` / ``denoising_end`` windows, precomputed prompt
embeddings, the tiled VAE, and ``output_type`` "np", "uint8",
"uint8_device" (uint8 left on the card) or "latents".  On an SDXL model
(one with a second text tower) the prompts go through both towers, with
``prompt_2`` / ``negative_prompt_2`` for the second, their penultimate
hidden states concatenated, and the UNet takes SDXL's micro-conditioning
(``added_cond``: the pooled embedding of the last tower and the
``_add_time_ids``); ``pooled_prompt_embeds`` may come precomputed, and
``use_refiner`` runs the loaded refiner UNet, conditioned on the second
tower alone, in place of the base.  ``cross_attention_kwargs={"scale": s}``
scales the text towers' LoRA adapters for one call: the towers run through
``torch.func.functional_call`` with weights fused from the pristine copies
at each adapter's scale times `s`, while the UNet keeps its fused weights,
as in JAX (``unified.py:449-480``).

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
weighting and editing (item 15).  SD3's arguments (``prompt_3``,
``max_sequence_length``) belong to ``pipelines/sd3.py``; here they are
unexpected keywords, as in the JAX pipeline.
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


def to_nchw(x, channels: int, device: torch.device) -> torch.Tensor:
    """NHWC or NCHW latents -> an NCHW tensor on `device`."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                        device=device)
    if x.dim() == 4 and x.shape[-1] == channels:
        return x.permute(0, 3, 1, 2)
    if x.dim() == 4 and x.shape[1] == channels:
        return x
    raise ValueError(f"cannot interpret latents of shape {tuple(x.shape)}")


@torch.no_grad()
def clip_encode(tokenizer, encoder, texts: List[str], mode: str, device: torch.device,
                clip_skip: Optional[int] = None,
                weights: Optional[Dict[str, torch.Tensor]] = None):
    """-> (hidden states [B, 77, H], pooled [B, P]) of one CLIP tower
    (``unified.py:91-108``).  mode "last": the last hidden state;
    "skip_renorm" (SD1.x clip skip): the hidden state `clip_skip` layers
    before the last, through final_layer_norm; "penultimate" (SDXL, SD3):
    hidden_states[-(clip_skip + 2)], no final norm.  The pooled output is
    the projected one of a tower that has a projection (bigG; SD3's CLIP-L
    too).  `weights` ({name: tensor}) stand in for the tower's own for this
    call."""
    ids = torch.from_numpy(tokenizer(texts)).to(device)
    out = (torch.func.functional_call(encoder, weights, (ids,)) if weights
           else encoder(ids))
    pooled = out.projected_pooled if encoder.config.with_projection else out.pooled_output
    if mode == "last":
        h = out.last_hidden_state
    elif mode == "skip_renorm":
        h = encoder.final_layer_norm(out.hidden_states[-(clip_skip + 1)])
    elif mode == "penultimate":
        h = out.skip_layer(clip_skip or 0)
    else:
        raise ValueError(mode)
    return h, pooled


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

    # -- prompt encoding (unified.py:91-108, 438-587) -------------------------
    def _clip_encode(self, tokenizer, encoder, texts: List[str], mode: str,
                     clip_skip: Optional[int] = None,
                     weights: Optional[Dict[str, torch.Tensor]] = None):
        return clip_encode(tokenizer, encoder, texts, mode, self.device, clip_skip, weights)

    def encode_prompt(
        self,
        model: SDModel,
        prompt: Union[str, List[str]],
        prompt_2: Union[str, List[str], None] = None,
        negative_prompt: Union[str, List[str], None] = None,
        negative_prompt_2: Union[str, List[str], None] = None,
        num_images_per_prompt: int = 1,
        clip_skip: Optional[int] = None,
        do_cfg: bool = True,
        refiner_mode: bool = False,
        lora_scale: Optional[float] = None,
    ):
        """-> (embeds, neg_embeds, pooled, neg_pooled), each [B * n, ...],
        the negatives None without CFG.  SDXL: both towers, `prompt_2` and
        `negative_prompt_2` defaulting to `prompt` and `negative_prompt`,
        hidden states concatenated on the last axis, pooled from the last
        tower; `refiner_mode` uses the second tower alone.  The clip skip
        applies to the prompts, not to the negatives, as in JAX.
        `lora_scale` scales the towers' adapters for this call."""
        prompt = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompt)
        tw = {c: None if lora_scale is None else model.scaled_tower_weights(c, lora_scale)
              for c in ("text_encoder", "text_encoder_2")}
        towers = [(model.tokenizer, model.text_encoder, tw["text_encoder"])]
        prompts = [prompt]
        if model.is_sdxl:
            prompt_2 = prompt_2 or prompt
            prompt_2 = [prompt_2] if isinstance(prompt_2, str) else list(prompt_2)
            towers.append((model.tokenizer_2, model.text_encoder_2, tw["text_encoder_2"]))
            prompts = [prompt, prompt_2]
            if refiner_mode:  # the refiner conditions on encoder 2 only
                towers, prompts = towers[1:], [prompt_2]
        negs = None
        if do_cfg:
            negative_prompt = negative_prompt or ""
            negative_prompt_2 = negative_prompt_2 or negative_prompt
            as_list = lambda x: [x] * B if isinstance(x, str) else list(x)  # noqa: E731
            neg, neg2 = as_list(negative_prompt), as_list(negative_prompt_2)
            if len(neg) != B:
                raise ValueError(f"negative_prompt batch {len(neg)} != prompt batch {B}")
            negs = [neg, neg2] if model.is_sdxl else [neg]
            if refiner_mode:
                negs = [neg2]

        def encode(texts, use_clip_skip):
            hs, pooled = [], None
            for txts, (tok, enc, weights) in zip(texts, towers):
                if model.is_sdxl:
                    mode, skip = "penultimate", (clip_skip if use_clip_skip else 0)
                elif use_clip_skip and clip_skip:
                    mode, skip = "skip_renorm", clip_skip
                else:
                    mode, skip = "last", None
                h, pooled = self._clip_encode(tok, enc, txts, mode, skip, weights)
                hs.append(h)
            return torch.cat(hs, dim=-1), pooled

        embeds, pooled = encode(prompts, use_clip_skip=True)
        neg_embeds = neg_pooled = None
        if do_cfg:
            neg_embeds, neg_pooled = encode(negs, use_clip_skip=False)
        n = num_images_per_prompt
        tile = lambda x: x.repeat_interleave(n, dim=0) if x is not None else None  # noqa: E731
        return tile(embeds), tile(neg_embeds), tile(pooled), tile(neg_pooled)

    # -- SDXL micro-conditioning (unified.py:695-715) -----------------------
    def _add_time_ids(self, model: SDModel, cfg, height: int, width: int, batch: int):
        """(positive, negative) time ids, fp32 [batch, 6], or [batch, 5] for
        a refiner-style UNet, which takes an aesthetic score (6.0 and 2.5)
        in place of the target size."""
        expected = cfg.projection_class_embeddings_input_dim
        proj_dim = model.text_encoder_2_config.projection_dim
        if expected == proj_dim + 5 * cfg.addition_time_embed_dim:
            pos = [height, width, 0, 0, 6.0]
            neg = [height, width, 0, 0, 2.5]
        else:
            pos = [height, width, 0, 0, height, width]
            neg = pos
            got = proj_dim + len(pos) * cfg.addition_time_embed_dim
            if got != expected:
                raise ValueError(f"add_embedding expects {expected}, constructed {got}")
        mk = lambda v: torch.tensor(  # noqa: E731
            v, dtype=torch.float32, device=self.device)[None].repeat(batch, 1)
        return mk(pos), mk(neg)

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
    def _denoise(self, model: SDModel, unet, latents: torch.Tensor, embeds: torch.Tensor,
                 added_cond: Optional[Dict[str, torch.Tensor]],
                 plan: Plan, draws: _Draws, guidance_scale: float,
                 guidance_rescale: float, do_cfg: bool, inpaint_mode: str = "none",
                 mask: Optional[torch.Tensor] = None,
                 masked_image_latents: Optional[torch.Tensor] = None,
                 image_latents: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The hot loop (unified.py:209-400 without its extensions) over
        `unet` (the base or the refiner): latents NCHW in the compute dtype;
        CFG batch order [uncond | text], `added_cond` already in it; the
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
            pred = unet(x, t, embeds, added_cond)
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
        prompt_2: Union[str, List[str], None] = None,
        negative_prompt: Union[str, List[str], None] = None,
        negative_prompt_2: Union[str, List[str], None] = None,
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
        cross_attention_kwargs: Optional[dict] = None,  # {"scale": text-tower LoRA scale}
        clip_skip: Optional[int] = None,
        seed: Union[int, List[int], None] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: Optional[str] = None,
        image=None,
        strength: float = 1.0,
        mask_image=None,
        masked_image_latents=None,
        padding_mask_crop: Optional[int] = None,
        use_refiner: bool = False,
        vae_tiling: bool = False,
        prompt_embeds=None,
        negative_prompt_embeds=None,
        pooled_prompt_embeds=None,
        negative_pooled_prompt_embeds=None,
        draws: Optional[Dict[str, np.ndarray]] = None,
        **extensions,
    ) -> SDPipelineOutput:
        """`draws` injects the random draws (NHWC arrays by use site:
        "latents", "encode", "encode_masked", and "steps" [N, B, h, w, c])
        in place of the generators, as the train step takes ``draws=``."""
        _check_unported(extensions)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, pipeline on {self.device}")
        if use_refiner:
            if model.refiner is None:
                raise ValueError("use_refiner=True but no refiner loaded "
                                 "(call model.load_refiner())")
            ucfg, unet = model.refiner_config, model.refiner
        else:
            ucfg, unet = model.unet_config, model.unet
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
            given = lambda x: (torch.as_tensor(x, device=self.device)  # noqa: E731
                               if x is not None else None)
            embeds, pooled = given(prompt_embeds), given(pooled_prompt_embeds)
            neg_embeds = given(negative_prompt_embeds)
            if neg_embeds is None and do_cfg:
                neg_embeds = torch.zeros_like(embeds)
            neg_pooled = given(negative_pooled_prompt_embeds)
            if neg_pooled is None and do_cfg and pooled is not None:
                neg_pooled = torch.zeros_like(pooled)
            tile = lambda x: x.repeat_interleave(n, dim=0) if x is not None else None  # noqa: E731
            embeds, neg_embeds = tile(embeds), tile(neg_embeds)
            pooled, neg_pooled = tile(pooled), tile(neg_pooled)
        else:
            embeds, neg_embeds, pooled, neg_pooled = self.encode_prompt(
                model, prompt, prompt_2, negative_prompt, negative_prompt_2,
                num_images_per_prompt=n, clip_skip=clip_skip, do_cfg=do_cfg,
                refiner_mode=use_refiner,
                lora_scale=(cross_attention_kwargs or {}).get("scale"))
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
                latents = to_nchw(latents, unet_c, self.device).float()
            # given latents are scaled too (unified.py:1101)
            latents = latents * plan.init_noise_sigma
        elif mask_image is None:  # img2img
            image_arr = self._image_or_latents(image, lat_c)
            plan, _ = self.get_timesteps(scheduler, num_inference_steps, strength, start,
                                         timesteps=timesteps, sigmas=sigmas)
            if getattr(image_arr, "ndim", 0) == 4 and image_arr.shape[-1] == lat_c:
                init_latents = to_nchw(image_arr, lat_c, self.device)
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
                noise4 = to_nchw(latents, lat_c, self.device).float()
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
                masked_lat = to_nchw(masked_image_latents, lat_c, self.device)
            elif inpaint_mode == "concat9":
                masked_lat = self._vae_encode(model, init_image * (mask_np < 0.5), rng,
                                              "encode_masked", vae_tiling)
                masked_lat = masked_lat.repeat(B * n // masked_lat.shape[0], 1, 1, 1)

        if denoising_end is not None and _denoising_valid(denoising_end):
            if start is not None and denoising_start >= denoising_end:
                raise ValueError(
                    f"denoising_start {denoising_start} >= denoising_end {denoising_end}")
            plan = self._apply_denoising_end(plan, scheduler, denoising_end)

        added_cond = None
        if model.is_sdxl:
            add_ids, add_neg_ids = self._add_time_ids(model, ucfg, height, width, B * n)
            text_embeds = pooled
            if do_cfg:
                text_embeds = torch.cat([neg_pooled, pooled])
                add_ids = torch.cat([add_neg_ids, add_ids])
            added_cond = {"text_embeds": text_embeds.to(self.dtype), "time_ids": add_ids}
        if do_cfg:
            embeds = torch.cat([neg_embeds.to(self.dtype), embeds])
        latents = self._denoise(
            model, unet, latents.to(self.dtype), embeds, added_cond, plan, rng,
            float(guidance_scale), float(guidance_rescale), do_cfg, inpaint_mode,
            mask_lat, masked_lat, image_lat, noise4)

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
