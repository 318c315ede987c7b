"""The unified pipeline: txt2img, img2img and inpainting, SD1.x/2.x and SDXL.

Port of ``stablediffusion_tpu/pipelines/unified.py`` (``__call__``
:760-1492): the mode follows from the inputs (no image: txt2img; an image:
img2img at ``strength``; an image and a mask: inpainting, ``blend4`` on a
4-channel UNet, ``concat9`` on a 9-channel one, with ``padding_mask_crop`` and
``masked_image_latents``), CFG with ``guidance_rescale``, clip skip,
``timesteps=`` / ``sigmas=`` schedules, ``denoising_start`` /
``denoising_end`` windows, precomputed prompt embeddings, the tiled VAE, and
``output_type`` "np", "uint8", "uint8_device" (uint8 left on the card) or
"latents".  On an SDXL model (one with a second text tower) the prompts go
through both towers, with ``prompt_2`` / ``negative_prompt_2`` for the
second, their penultimate hidden states concatenated, and the UNet takes
SDXL's micro-conditioning (``added_cond``: the pooled embedding of the last
tower and the ``_add_time_ids``); ``pooled_prompt_embeds`` may come
precomputed, and ``use_refiner`` runs the loaded refiner UNet, conditioned
on the second tower alone, in place of the base.
``cross_attention_kwargs={"scale": s}`` scales the text towers' LoRA
adapters for one call: the towers run through ``torch.func.functional_call``
with weights fused from the pristine copies at each adapter's scale times
`s`, while the UNet keeps its fused weights, as in JAX (``unified.py:449-480``).

The extensions, with the JAX package's semantics and checks:

  * ``prompt_weighting``: A1111 emphasis, prompts of more than 75 tokens in
    chunks (:523-575), and ``[from:to:when]`` / ``[a|b]`` prompt editing: one
    embedding per unique realised prompt, picked by step (:1008-1060, :250);
    pooled embeds stay at the first variant;
  * ``hires_scale``: a txt2img pass at the 8-px-snapped downscaled size,
    its latents upscaled bilinearly in fp32, then img2img at
    ``hires_strength`` (:589, checks :851-866);
  * ``freeu``: True (the family's defaults) or (b1, b2, s1, s2) (:64);
  * ``pag_scale`` on ``pag_applied_layers``: one more UNet call on the
    conditional half with those groups' self-attention the identity map
    (:328-351, checks :836-846);
  * ``cache_interval``: DeepCache; each interval's first step runs the full
    UNet and caches its deep features, the others run the outermost level
    against them, and the steps past the last whole interval are full
    (:365-394);
  * ``image_guidance_scale``: InstructPix2Pix on an 8-channel UNet, three
    branches over the image's unscaled VAE mode (:268-281, :316-323,
    :1102-1141, checks :917-942);
  * ``control_image``: the loaded ControlNet's residuals, the image resized
    to latent size x 8 in [0, 1] (:295-306, :1338-1354);
  * ``ip_adapter_image`` / ``ip_adapter_image_embeds``: IP-Adapter's image
    tokens (:717-757, :1317-1336); a standard adapter's negative is the
    projection of zero embeds, a Plus adapter's that of a zero image.

The denoise loop is a Python loop over the scheduler's ``step``; latents stay
in the compute dtype between steps, the scheduler state in fp32, as in the
JAX scan.  Random draws come from one ``torch.Generator`` per use site
(latents, VAE encode, step noise, masked-image encode), seeded from the
request's seed; with a seed list, one generator per sample and site, so a
sample's image depends on its own seed only.  The JAX package splits a
``jax.random`` key instead, so the streams differ; parity tests inject the
JAX draws through ``draws=`` (the hires fix takes one dict per pass).

Public layouts are the JAX package's: ``latents`` in and ``output_type=
"latents"`` out are NHWC [B, h, w, 4]; images are NHWC [B, H, W, 3].  The
loop itself runs on NCHW.  SD3's arguments (``prompt_3``,
``max_sequence_length``) belong to ``pipelines/sd3.py``; here they are
unexpected keywords, as in the JAX pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

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
from stablediffusion_tpu_torch.utils import prompt_edit as pe
from stablediffusion_tpu_torch.utils import prompt_weights as pw


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


def _resolve_freeu(freeu, model_type: str):
    """The ``freeu=`` argument as (b1, b2, s1, s2) or None (``unified.py:64``):
    True picks the family's defaults, a 4-sequence passes through."""
    if freeu is None or freeu is False:
        return None
    from stablediffusion_tpu_torch.ops.freeu import SD15_DEFAULTS, SDXL_DEFAULTS

    if freeu is True:
        return SDXL_DEFAULTS if model_type == "sdxl" else SD15_DEFAULTS
    vals = tuple(float(v) for v in freeu)
    if len(vals) != 4:
        raise ValueError(f"freeu must be True or (b1, b2, s1, s2); got {freeu!r}")
    return vals


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


def embeds_at(embeds, i: int) -> torch.Tensor:
    """The prompt embedding of step `i`: `embeds` itself, or under prompt
    editing, from its (stack, starts, idx_map) triple, the unique variant of
    the last interval whose start (in local step units) `i` has reached
    (``unified.py:250``)."""
    if isinstance(embeds, tuple):
        stack, starts, idx_map = embeds
        return stack[idx_map[sum(1 for s0 in starts if i >= s0) - 1]]
    return embeds


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
def clip_encode(tokenizer, encoder, texts: Optional[List[str]], mode: str, device: torch.device,
                clip_skip: Optional[int] = None,
                weights: Optional[Dict[str, torch.Tensor]] = None,
                ids: Optional[np.ndarray] = None):
    """-> (hidden states [B, 77, H], pooled [B, P]) of one CLIP tower
    (``unified.py:91-108``).  mode "last": the last hidden state;
    "skip_renorm" (SD1.x clip skip): the hidden state `clip_skip` layers
    before the last, through final_layer_norm; "penultimate" (SDXL, SD3):
    hidden_states[-(clip_skip + 2)], no final norm.  The pooled output is
    the projected one of a tower that has a projection (bigG; SD3's CLIP-L
    too).  `weights` ({name: tensor}) stand in for the tower's own for this
    call; `ids` [B, 77], when given, stand for the tokenized `texts`."""
    ids = torch.from_numpy(np.asarray(tokenizer(texts) if ids is None else ids)).to(device)
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
                     weights: Optional[Dict[str, torch.Tensor]] = None, ids=None):
        return clip_encode(tokenizer, encoder, texts, mode, self.device, clip_skip, weights,
                           ids)

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
        prompt_weighting: bool = False,
        min_chunks: int = 1,
    ):
        """-> (embeds, neg_embeds, pooled, neg_pooled), each [B * n, ...],
        the negatives None without CFG.  SDXL: both towers, `prompt_2` and
        `negative_prompt_2` defaulting to `prompt` and `negative_prompt`,
        hidden states concatenated on the last axis, pooled from the last
        tower; `refiner_mode` uses the second tower alone.  The clip skip
        applies to the prompts, not to the negatives, as in JAX.
        `lora_scale` scales the towers' adapters for this call.  Under
        `prompt_weighting` each tower encodes A1111 chunks of 75 tokens, at
        least `min_chunks` and as many as the longest prompt or negative
        needs (one count for the whole call, so the CFG halves match), the
        hidden states [B, k * 77, D] weighted per token, the pooled output
        from chunk 0 (``unified.py:521-575``)."""
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

        n_chunks = max(1, int(min_chunks))
        streams: dict = {}  # (tower index, is_neg) -> [token_stream(text), ...]
        if prompt_weighting:
            for i, (tok, _, _) in enumerate(towers):
                lists = [(False, prompts[i])] + ([(True, negs[i])] if negs else [])
                for is_neg, txts in lists:
                    ss = [pw.token_stream(tok, t) for t in txts]
                    streams[(i, is_neg)] = ss
                    for ids, _ in ss:
                        n_chunks = max(n_chunks, -(-max(len(ids), 1) // 75))

        def encode(texts, use_clip_skip, is_neg=False):
            hs, pooled = [], None
            for i, (txts, (tok, enc, weights)) in enumerate(zip(texts, towers)):
                ids = token_weights = None
                if prompt_weighting:
                    ids_np, w_np = pw.encode_chunked(tok, txts, k=n_chunks,
                                                     streams=streams[(i, is_neg)])
                    Bq, kq, Lq = ids_np.shape
                    ids = ids_np.reshape(Bq * kq, Lq)
                    if (w_np != 1.0).any():
                        token_weights = w_np.reshape(Bq, kq * Lq)
                if model.is_sdxl:
                    mode, skip = "penultimate", (clip_skip if use_clip_skip else 0)
                elif use_clip_skip and clip_skip:
                    mode, skip = "skip_renorm", clip_skip
                else:
                    mode, skip = "last", None
                h, pooled = self._clip_encode(tok, enc, txts, mode, skip, weights, ids)
                if prompt_weighting:  # [B * k, L, D] -> [B, k * L, D]; pooled of chunk 0
                    h = h.reshape(Bq, kq * Lq, h.shape[-1])
                    if pooled is not None:
                        pooled = pooled.reshape(Bq, kq, *pooled.shape[1:])[:, 0]
                if token_weights is not None:
                    h = pw.apply_token_weights(h, token_weights)
                hs.append(h)
            return torch.cat(hs, dim=-1), pooled

        embeds, pooled = encode(prompts, use_clip_skip=True)
        neg_embeds = neg_pooled = None
        if do_cfg:
            neg_embeds, neg_pooled = encode(negs, use_clip_skip=False, is_neg=True)
        n = num_images_per_prompt
        tile = lambda x: x.repeat_interleave(n, dim=0) if x is not None else None  # noqa: E731
        return tile(embeds), tile(neg_embeds), tile(pooled), tile(neg_pooled)

    def _hires_fix(self, model: SDModel, scale: float, strength: float, hires_steps,
                   common: dict, draws, *, height: int, width: int, output_type,
                   vae_tiling) -> "SDPipelineOutput":
        """A1111's two-pass hires fix (``unified.py:589``): txt2img at the
        size divided by `scale` and snapped to 8 px, the latents upscaled
        bilinearly in fp32 (half-pixel centres, as ``jax.image.resize``
        upscales), then img2img at `strength`.  Both passes go through
        ``__call__``; `draws` is None or one dict per pass."""
        vf = model.vae_scale_factor
        snap = 8
        base_h = max(int(round(height / scale / snap)) * snap, vf * snap)
        base_w = max(int(round(width / scale / snap)) * snap, vf * snap)
        d1, d2 = draws if draws is not None else (None, None)
        lat = self(model, height=base_h, width=base_w, output_type="latents", draws=d1,
                   **common).latents
        up = F.interpolate(lat.permute(0, 3, 1, 2).float(), size=(height // vf, width // vf),
                           mode="bilinear", align_corners=False, antialias=False)
        overrides = {"num_inference_steps": hires_steps or common["num_inference_steps"]}
        if hires_steps and (common.get("timesteps") is not None
                            or common.get("sigmas") is not None):
            # an explicit hires_steps wins over a custom base schedule
            overrides["timesteps"] = overrides["sigmas"] = None
        return self(model, image=up.permute(0, 2, 3, 1), strength=strength, height=height,
                    width=width, output_type=output_type, vae_tiling=vae_tiling, draws=d2,
                    **{**common, **overrides})

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
                    site: str, tiling: bool, sample: bool = True) -> torch.Tensor:
        """NHWC pixels in [-1, 1] -> NCHW latents sampled from the encoder's
        distribution (its mean without `sample`) and scaled
        (unified.py:110-150)."""
        x = torch.as_tensor(np.asarray(image_nhwc), device=self.device).permute(0, 3, 1, 2)
        if model.vae_config.force_upcast:
            x = x.float()
        else:
            x = x.to(next(model.vae.parameters()).dtype)
        mean, logvar = tiled_encode(model.vae, x) if tiling else model.vae.encode(x)
        if not sample:
            return mean * model.vae_config.scaling_factor
        eps = draws.randn(site, mean).to(mean.dtype)
        z = mean + torch.exp(0.5 * logvar) * eps
        return z * model.vae_config.scaling_factor

    @torch.no_grad()
    def _encode_ip_image(self, model: SDModel, image, batch: int, do_cfg: bool) -> torch.Tensor:
        """The IP-Adapter's context tokens for `image`, [neg | pos] under CFG
        (``unified.py:717-757``): a standard adapter projects the image
        encoder's projected embed, its negative zero embeds; a Plus adapter
        resamples the penultimate hidden states, its negative those of a
        zero pixel tensor."""
        from stablediffusion_tpu_torch.models.ip_adapter import project_image_embeds

        if model.ip_adapter is None:
            raise ValueError("no IP-Adapter loaded (call model.load_ip_adapter())")
        if model.image_encoder is None:
            raise ValueError("no image encoder loaded (call model.load_image_encoder())")
        vcfg = model.image_encoder_config
        pixels = torch.from_numpy(np.ascontiguousarray(
            img_utils.clip_image_preprocess(image, vcfg.image_size))).to(self.device)
        pixels = pixels.permute(0, 3, 1, 2)

        def vision(px):
            out = model.image_encoder(px)
            feats = out.image_embeds if out.image_embeds is not None else out.pooled_output
            return feats, out.penultimate()

        proj = model.ip_adapter.image_proj
        embeds, hidden = vision(pixels)
        neg = None
        if model.ip_adapter.config.kind == "proj":
            tokens = project_image_embeds(proj, embeds)
            if do_cfg:
                neg = project_image_embeds(proj, torch.zeros_like(embeds))
        else:
            tokens = project_image_embeds(proj, hidden)
            if do_cfg:
                neg = project_image_embeds(proj, vision(torch.zeros_like(pixels))[1])
        tokens = tokens.repeat(batch // tokens.shape[0], 1, 1)
        if do_cfg:
            tokens = torch.cat([neg.repeat(batch // neg.shape[0], 1, 1), tokens])
        return tokens

    @torch.no_grad()
    def _denoise(self, model: SDModel, unet, latents: torch.Tensor, embeds,
                 added_cond: Optional[Dict[str, torch.Tensor]],
                 plan: Plan, draws: _Draws, guidance_scale: float,
                 guidance_rescale: float, do_cfg: bool, inpaint_mode: str = "none",
                 mask: Optional[torch.Tensor] = None,
                 masked_image_latents: Optional[torch.Tensor] = None,
                 image_latents: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 ip_tokens: Optional[torch.Tensor] = None, ip_scale=None,
                 pag_scale: Optional[float] = None, image_guidance: Optional[float] = None,
                 cache_interval: int = 1, controlnet=None,
                 control_image: Optional[torch.Tensor] = None, controlnet_scale: float = 1.0,
                 freeu=None, pag_layers: tuple = ("mid",)) -> torch.Tensor:
        """The hot loop (unified.py:209-394) over `unet` (the base or the
        refiner): latents NCHW in the compute dtype; CFG batch order [uncond
        | text], `added_cond` already in it; the guidance combines in fp32.
        `embeds` is a tensor or, under prompt editing, a (stack, starts,
        idx_map) triple; "ip2p" is InstructPix2Pix's three-branch mode."""
        scheduler = model.scheduler
        N = plan.num_steps
        state = scheduler.init_state(plan, latents.shape, latents.device)
        if inpaint_mode == "concat9":
            m = torch.cat([mask, mask]) if do_cfg else mask
            mi = torch.cat([masked_image_latents] * 2) if do_cfg else masked_image_latents

        def cond_half(a):
            if a is None:
                return None
            return a[a.shape[0] // 2:] if do_cfg else a

        def one_step(lat, state, i, deep_cache=None, want_cache=False):
            emb = embeds_at(embeds, i)
            if inpaint_mode == "ip2p":
                # (text, image), (uncond, image), (uncond, zeros); the image
                # latents are the unscaled mode of the input image
                bh = emb.shape[0] // 2
                emb = torch.cat([emb[bh:], emb[:bh], emb[:bh]])
                x = scheduler.scale_model_input(plan, torch.cat([lat, lat, lat]), i)
                il = torch.cat([image_latents, image_latents, torch.zeros_like(image_latents)])
                x = torch.cat([x, il.to(x.dtype)], dim=1)
            else:
                x = torch.cat([lat, lat]) if do_cfg else lat
                x = scheduler.scale_model_input(plan, x, i)
            if inpaint_mode == "concat9":
                x = torch.cat([x, m.to(x.dtype), mi.to(x.dtype)], dim=1)
            t = torch.tensor(plan.timesteps[i], device=lat.device)
            down_res = mid_res = None
            if controlnet is not None:
                ci = torch.cat([control_image, control_image]) if do_cfg else control_image
                down_res, mid_res = controlnet(x, t, emb, ci, controlnet_scale, added_cond)
            result = unet(x, t, emb, added_cond, deep_cache=deep_cache,
                          return_deep_cache=want_cache, down_block_residuals=down_res,
                          mid_block_residual=mid_res, ip_hidden_states=ip_tokens,
                          ip_scale=ip_scale, freeu=freeu)
            pred, deep = result if want_cache else (result, None)
            text = pred
            if inpaint_mode == "ip2p":
                t3, i3, u3 = pred.float().chunk(3)
                text = t3
                pred = u3 + guidance_scale * (t3 - i3) + image_guidance * (i3 - u3)
            elif do_cfg:
                uncond, text = pred.float().chunk(2)
                pred = uncond + guidance_scale * (text - uncond)
                if guidance_rescale > 0.0:
                    pred = rescale_noise_cfg(pred, text, guidance_rescale)
            if pag_scale is not None:
                # PAG: the conditional branch again with the chosen groups'
                # self-attention the identity; guide away from it
                pert = unet(cond_half(x), t, cond_half(emb),
                            None if added_cond is None
                            else {k: cond_half(v) for k, v in added_cond.items()},
                            down_block_residuals=(None if down_res is None
                                                  else [cond_half(r) for r in down_res]),
                            mid_block_residual=cond_half(mid_res),
                            ip_hidden_states=cond_half(ip_tokens), ip_scale=ip_scale,
                            freeu=freeu, pag_perturb=pag_layers)
                pred = pred.float() + pag_scale * (text.float() - pert.float())
            step_noise_i = draws.step(i, lat) if scheduler.uses_noise() else None
            lat, state = scheduler.step(plan, state, i, pred, lat, noise=step_noise_i)
            if inpaint_mode == "blend4":
                # the known region follows the image, re-noised to the next
                # step's level (add_noise at i + 1)
                init_prop = (scheduler.add_noise_index(plan, image_latents, noise, i + 1)
                             if i < N - 1 else image_latents)
                mk = mask.to(lat.dtype)
                lat = (1.0 - mk) * init_prop.to(lat.dtype) + mk * lat
            return lat, state, deep

        k = max(int(cache_interval), 1)
        n_outer = N // k if k > 1 else 0
        for o in range(n_outer):  # DeepCache: a full step, then k - 1 shallow ones
            latents, state, deep = one_step(latents, state, o * k, want_cache=True)
            for j in range(1, k):
                latents, state, _ = one_step(latents, state, o * k + j, deep_cache=deep)
        for i in range(n_outer * k, N):
            latents, state, _ = one_step(latents, state, i)
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
        draws=None,
        cache_interval: Optional[int] = None,
        control_image=None,
        controlnet_conditioning_scale: float = 1.0,
        prompt_weighting: bool = False,
        ip_adapter_image=None,
        ip_adapter_image_embeds=None,
        ip_adapter_scale: Optional[float] = None,
        hires_scale: Optional[float] = None,
        hires_strength: float = 0.7,
        hires_steps: Optional[int] = None,
        freeu: Union[bool, tuple, list, None] = None,
        pag_scale: float = 0.0,
        pag_applied_layers: Union[tuple, list] = ("mid",),
        image_guidance_scale: Optional[float] = None,
    ) -> SDPipelineOutput:
        """`draws` injects the random draws (NHWC arrays by use site:
        "latents", "encode", "encode_masked", and "steps" [N, B, h, w, c])
        in place of the generators, as the train step takes ``draws=``;
        under ``hires_scale``, a pair of such dicts, one per pass."""
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, pipeline on {self.device}")
        freeu = _resolve_freeu(freeu, model.model_type)
        pag_layers = tuple(sorted(set(pag_applied_layers or ())))
        use_pag = bool(pag_scale) and float(pag_scale) > 0.0
        if use_pag:
            bad = [g for g in pag_layers if g not in ("down", "mid", "up")]
            if bad or not pag_layers:
                raise ValueError("pag_applied_layers must be a non-empty subset of "
                                 f"('down', 'mid', 'up'); got {pag_applied_layers!r}")
            if cache_interval and int(cache_interval) > 1:
                raise ValueError("pag_scale and cache_interval>1 cannot combine (the cached "
                                 "shallow steps skip the perturbed blocks)")
        scheduler = model.scheduler
        num_inference_steps = resolve_custom_schedule(num_inference_steps, timesteps, sigmas)
        vf = model.vae_scale_factor
        if hires_scale is not None and float(hires_scale) > 1.0:
            if image is not None or mask_image is not None or use_refiner:
                raise ValueError("hires_scale applies to txt2img only")
            if latents is not None:
                raise ValueError("hires_scale cannot take pinned latents= (the base pass runs "
                                 "at height/scale — pass a seed instead)")
            if _denoising_valid(denoising_start) or _denoising_valid(denoising_end):
                raise ValueError("hires_scale and denoising_start/denoising_end windows "
                                 "cannot combine")
            common = dict(
                prompt=prompt, prompt_2=prompt_2, negative_prompt=negative_prompt,
                negative_prompt_2=negative_prompt_2, num_images_per_prompt=num_images_per_prompt,
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                clip_skip=clip_skip, seed=seed, num_inference_steps=num_inference_steps,
                timesteps=timesteps, sigmas=sigmas, cache_interval=cache_interval,
                cross_attention_kwargs=cross_attention_kwargs,
                prompt_weighting=prompt_weighting, control_image=control_image,
                controlnet_conditioning_scale=controlnet_conditioning_scale,
                ip_adapter_image=ip_adapter_image,
                ip_adapter_image_embeds=ip_adapter_image_embeds,
                ip_adapter_scale=ip_adapter_scale, prompt_embeds=prompt_embeds,
                negative_prompt_embeds=negative_prompt_embeds,
                pooled_prompt_embeds=pooled_prompt_embeds,
                negative_pooled_prompt_embeds=negative_pooled_prompt_embeds,
                freeu=freeu, pag_scale=pag_scale, pag_applied_layers=pag_applied_layers)
            return self._hires_fix(
                model, float(hires_scale), hires_strength, hires_steps, common, draws,
                height=height or model.unet_config.sample_size * vf,
                width=width or model.unet_config.sample_size * vf,
                output_type=output_type, vae_tiling=vae_tiling)
        if use_refiner:
            if model.refiner is None:
                raise ValueError("use_refiner=True but no refiner loaded "
                                 "(call model.load_refiner())")
            ucfg, unet = model.refiner_config, model.refiner
        else:
            ucfg, unet = model.unet_config, model.unet
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
        if image_guidance_scale is not None:
            if image is None or mask_image is not None:
                raise ValueError("image_guidance_scale (InstructPix2Pix) needs `image` "
                                 "and no mask")
            if ucfg.in_channels != 8:
                raise ValueError("InstructPix2Pix needs an 8-channel UNet; this model "
                                 f"has {ucfg.in_channels} input channels")
            if model.is_sdxl or use_refiner:
                raise ValueError("InstructPix2Pix is an SD1.x-family mode")
            if use_pag or (ip_adapter_image is not None or ip_adapter_image_embeds is not None
                           or control_image is not None):
                raise ValueError("image_guidance_scale cannot combine with PAG / "
                                 "IP-Adapter / ControlNet")
            do_cfg = True  # the three-branch combine needs the unconditional embeds
        elif ucfg.in_channels == 8:
            raise ValueError(
                "this model's UNet takes 8 input channels (an InstructPix2Pix checkpoint): "
                "pass image= and image_guidance_scale= — plain txt2img/img2img/inpaint "
                "cannot feed its extra image-latent channels")

        # seed: an int, or one per sample
        if isinstance(seed, (list, tuple)):
            seed = [int(s) for s in seed]
            if len(seed) != B * n:
                raise ValueError(f"seed list length {len(seed)} != batch {B * n}")
        elif seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        rng = _Draws(seed, self.device, draws)

        # prompts
        edit_starts = edit_idx_map = None
        edit_extra: list = []
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
            # prompt editing and alternation: one concrete prompt per step
            # interval, each unique one encoded once
            edit_variants = None
            if prompt_weighting and prompt is not None:
                texts = [prompt] if isinstance(prompt, str) else list(prompt)
                merged = pe.schedule_prompts(texts, num_inference_steps)
                if merged is not None and len(merged[0]) > 1:
                    edit_starts, edit_variants = merged
                elif merged is not None:
                    # one interval: encode the realised text, not the markup
                    prompt = merged[1][0]
            enc_common = dict(num_images_per_prompt=n, clip_skip=clip_skip,
                              refiner_mode=use_refiner,
                              lora_scale=(cross_attention_kwargs or {}).get("scale"),
                              prompt_weighting=prompt_weighting)
            if edit_variants is not None:
                # the variants share one sequence length: the chunk count of
                # the longest of them, prompt_2 and the negatives
                uniq, edit_idx_map = pe.unique_variants(edit_variants)
                toks = [model.tokenizer] + ([model.tokenizer_2] if model.is_sdxl else [])
                all_texts = [t for variant in uniq for t in variant]
                if prompt_2 is not None:
                    all_texts += [prompt_2] if isinstance(prompt_2, str) else list(prompt_2)
                if do_cfg:
                    for npx in (negative_prompt or "",
                                negative_prompt_2 or (negative_prompt or "")):
                        all_texts += [npx] if isinstance(npx, str) else list(npx)
                k_floor = max(pw.num_chunks(tok, t) for tok in toks for t in all_texts)
                embeds, neg_embeds, pooled, neg_pooled = self.encode_prompt(
                    model, uniq[0], prompt_2, negative_prompt, negative_prompt_2,
                    do_cfg=do_cfg, min_chunks=k_floor, **enc_common)
                edit_extra = [self.encode_prompt(model, v, prompt_2, None, None, do_cfg=False,
                                                 min_chunks=k_floor, **enc_common)[0]
                              for v in uniq[1:]]
            else:
                embeds, neg_embeds, pooled, neg_pooled = self.encode_prompt(
                    model, prompt, prompt_2, negative_prompt, negative_prompt_2,
                    do_cfg=do_cfg, **enc_common)
        embeds = embeds.to(self.dtype)

        lat_c = model.vae_config.latent_channels
        unet_c = ucfg.in_channels
        inpaint_mode = "none"
        mask_lat = masked_lat = image_lat = noise4 = None
        crop = original_image_np = mask_np = None
        start = denoising_start if _denoising_valid(denoising_start) else None
        # the steps a window skips: edit boundaries are in full-schedule steps
        step_offset = 0

        if image is None:  # txt2img
            plan = scheduler.plan(num_inference_steps, timesteps=timesteps, sigmas=sigmas)
            if start is not None:
                plan, step_offset = self.get_timesteps(
                    scheduler, num_inference_steps, 1.0, start, timesteps=timesteps,
                    sigmas=sigmas)
            shape = (B * n, unet_c, height // vf, width // vf)
            if latents is None:
                latents = rng.randn("latents", torch.empty(shape, device=self.device))
            else:
                latents = to_nchw(latents, unet_c, self.device).float()
            # given latents are scaled too (unified.py:1101)
            latents = latents * plan.init_noise_sigma
        elif image_guidance_scale is not None:
            # InstructPix2Pix: the whole schedule from noise; the UNet's extra
            # channels carry the image's VAE mode, unscaled, as the model was
            # trained (diffusers' prepare_image_latents, unified.py:1102-1141)
            inpaint_mode = "ip2p"
            plan = scheduler.plan(num_inference_steps, timesteps=timesteps, sigmas=sigmas)
            image_arr = self._image_or_latents(image, lat_c)
            if getattr(image_arr, "ndim", 0) == 4 and image_arr.shape[-1] == lat_c:
                image_lat = to_nchw(image_arr, lat_c, self.device).float()
            else:
                image_lat = self._vae_encode(
                    model, img_utils.preprocess_image(image_arr, height, width), rng,
                    "encode", vae_tiling, sample=False) / model.vae_config.scaling_factor
            image_lat = image_lat.repeat(B * n // image_lat.shape[0], 1, 1, 1)
            shape = (B * n, lat_c, height // vf, width // vf)
            if latents is None:
                latents = rng.randn("latents", torch.empty(shape, device=self.device))
            else:
                latents = to_nchw(latents, lat_c, self.device).float()
            latents = latents * plan.init_noise_sigma
            height, width = latents.shape[2] * vf, latents.shape[3] * vf
        elif mask_image is None:  # img2img
            image_arr = self._image_or_latents(image, lat_c)
            plan, step_offset = self.get_timesteps(scheduler, num_inference_steps, strength,
                                                   start, timesteps=timesteps, sigmas=sigmas)
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
        if edit_extra:
            # the unique variants stacked [U, 2B | B, L, D], the interval
            # starts in the sliced plan's local step units (an order-2 plan
            # spends two indices a sampler step), the interval -> variant map
            full = [embeds] + [torch.cat([neg_embeds.to(self.dtype), e.to(self.dtype)])
                               if do_cfg else e.to(self.dtype) for e in edit_extra]
            embeds = (torch.stack(full), [s0 * plan.order - step_offset for s0 in edit_starts],
                      list(edit_idx_map))

        # IP-Adapter image tokens
        ip_tokens = None
        if ip_adapter_image_embeds is not None:
            ip_tokens = torch.as_tensor(ip_adapter_image_embeds, device=self.device).to(self.dtype)
            want = 2 * B * n if do_cfg else B * n
            if ip_tokens.shape[0] == B * n and do_cfg:
                ip_tokens = torch.cat([torch.zeros_like(ip_tokens), ip_tokens])
            if ip_tokens.shape[0] != want:
                raise ValueError(f"ip_adapter_image_embeds batch {ip_tokens.shape[0]} != {want}")
        elif ip_adapter_image is not None:
            ip_tokens = self._encode_ip_image(model, ip_adapter_image, B * n,
                                              do_cfg).to(self.dtype)
        if ip_tokens is not None and model.ip_adapter is None:
            raise ValueError("ip_adapter image given but no IP-Adapter loaded "
                             "(call model.load_ip_adapter())")

        # the ControlNet's conditioning image: latent size x 8 (the embedder
        # downsamples by a fixed 8), in [0, 1]
        control_arr = None
        if control_image is not None:
            if model.controlnet is None:
                raise ValueError("control_image given but no ControlNet loaded "
                                 "(call model.load_controlnet())")
            control_np = img_utils.preprocess_image(control_image, (height // vf) * 8,
                                                    (width // vf) * 8)
            control_arr = torch.from_numpy((control_np + 1.0) / 2.0).to(self.device)
            control_arr = control_arr.to(self.dtype).permute(0, 3, 1, 2)
            control_arr = control_arr.repeat(B * n // control_arr.shape[0], 1, 1, 1)

        latents = self._denoise(
            model, unet, latents.to(self.dtype), embeds, added_cond, plan, rng,
            float(guidance_scale), float(guidance_rescale), do_cfg, inpaint_mode,
            mask_lat, masked_lat, image_lat, noise4,
            ip_tokens=ip_tokens,
            ip_scale=(None if ip_tokens is None else float(
                ip_adapter_scale if ip_adapter_scale is not None else model.ip_scale)),
            pag_scale=float(pag_scale) if use_pag else None,
            image_guidance=(None if image_guidance_scale is None
                            else float(image_guidance_scale)),
            cache_interval=int(cache_interval or 1),
            controlnet=model.controlnet if control_arr is not None else None,
            control_image=control_arr,
            controlnet_scale=float(controlnet_conditioning_scale),
            freeu=freeu, pag_layers=pag_layers)

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
