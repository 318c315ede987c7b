"""Diffusers-layout checkpoint folders -> SDModel or SD3Model, and back.

Port of ``stablediffusion_tpu/io/loader.py``:
``resolve_checkpoint`` (:42, local folders only), ``_find_weights`` (:169,
the fp16 variant first, sharded indexes), ``load_component_state`` (:187),
``_resolve_scheduler_name`` (:252), ``_read_quant_mode`` (:266),
``load_sd_model`` (:275; an SDXL folder adds ``text_encoder_2/`` and
``tokenizer_2/``, whose pad token comes from its special_tokens_map),
``load_sd3_model`` (:360; ``text_encoder_3/`` and ``tokenizer_3/``
optional), ``save_sd_model`` (:497) and ``save_sd3_model`` (:560) with their
``quantize=`` (``_check_fp_save`` :471, ``_quantized_tree`` :481),
``save_controlnet`` (:631) and the config writers (:649-680).  A ControlNet
folder (``load_controlnet``, JAX ``models/wrapper.py:117``) and an IP-Adapter
``image_encoder`` folder (``load_image_encoder``, JAX ``wrapper.py:376``)
load here too; ``save_image_encoder`` writes the latter.  The SDXL
refiner's folder is read by :func:`load_unet` (``SDModel.load_refiner``).
A1111/LDM single files load through :func:`load_sd_single_file` (:75-161, with ``io/convert_cli.
load_single_file`` :16-27), which converts them in memory with the port's
copy of ``io/a1111.py``; their dtypes follow ``load_sd_model``'s, not the
JAX loader's (which keeps the file's).

The port's modules carry diffusers' parameter names and torch layouts, which
are what diffusers files hold, so a component loads by a strict copy into
its ``state_dict``: no transposes, ``position_ids`` dropped, and every
missing, unexpected or misshapen key raises.  Components are built on the
meta device and filled straight from the safetensors mmap on their device.

An int8 folder (``quantize=``) holds its denoise tower in JAX's canonical
layout, every tensor (HWIO and (in, out) kernels, int8 codes and their fp32
scales under JAX's names), stamped ``sdtpu_layout: canonical`` and
``sdtpu_quant``, and model_index.json records the mode as ``_sdtpu_quant``;
``io/from_jax`` maps the layouts both ways, so such folders cross-load
between the two packages.  The tower loads into int8 layers swapped into
the meta-built module before it is allocated, so no floating-point copy of
it exists, and the model is ``quant_frozen``.  SD3 single files are
refused, as in JAX: SD3 loads from diffusers folders.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
from typing import Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    SchedulerConfig,
    SD3Config,
    UNetConfig,
    VAEConfig,
    default_dtype,
    resolve_device,
)
from stablediffusion_tpu_torch.io.from_jax import to_jax_layout, to_torch_layout
from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile, save_safetensors
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel
from stablediffusion_tpu_torch.models.t5 import T5Config, T5EncoderModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.ops.quant import (
    quantize_plan,
    quantized_layer,
    resolve_quant_mode,
    swap_in_int8_layers,
)
from stablediffusion_tpu_torch.pipelines.sd3 import SD3Model
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer
from stablediffusion_tpu_torch.tokenizer.sentencepiece_unigram import (
    SentencePieceUnigramTokenizer,
)

DEFAULT_CHECKPOINTS = {
    "sd15": "runwayml/stable-diffusion-v1-5",
    "sdxl": "stabilityai/stable-diffusion-xl-base-1.0",
}
REGISTRY_PREFIX = "OnMoon"

logger = logging.getLogger(__name__)


def resolve_checkpoint(
    model_type: str, model_name: Optional[str] = None, cache_dir: Optional[str] = None
) -> str:
    """model_name -> local path: ``{type}_{name}`` under the model dir
    (``SDTPU_MODEL_DIR``, default ``models``), a single file given by path
    or name, or the default checkpoint's folder name.  Local only: a
    checkpoint that is not on disk raises ``FileNotFoundError``."""
    cache_dir = cache_dir or os.environ.get("SDTPU_MODEL_DIR", "models")
    if model_name and model_name.endswith((".safetensors", ".ckpt")):
        for cand in (model_name, os.path.join(cache_dir, model_name)):
            if os.path.isfile(cand):
                return cand
        raise FileNotFoundError(f"single-file checkpoint {model_name!r} not "
                                f"found (also tried under {cache_dir})")
    if model_name is None:
        repo = DEFAULT_CHECKPOINTS[model_type]
        local = os.path.join(cache_dir, repo.split("/")[-1])
    else:
        local = os.path.join(cache_dir, f"{model_type}_{model_name}")
        repo = f"{REGISTRY_PREFIX}/{model_type}_{model_name}"
    if os.path.isdir(local):
        return local
    raise FileNotFoundError(
        f"checkpoint {repo!r} not found locally at {local} (the port reads "
        "local folders only)"
    )


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _find_weights(folder: str, variant: Optional[str] = "fp16"):
    """The weight file(s) of a component folder, the `variant` first; a
    sharded checkpoint through its index json."""
    names = os.listdir(folder)
    for base in ("diffusion_pytorch_model", "model"):
        for v in ([f".{variant}", ""] if variant else [""]):
            idx = f"{base}{v}.safetensors.index.json"
            if idx in names:
                index = _read_json(os.path.join(folder, idx))
                shards = sorted(set(index["weight_map"].values()))
                return [os.path.join(folder, s) for s in shards]
            fn = f"{base}{v}.safetensors"
            if fn in names:
                return [os.path.join(folder, fn)]
    raise FileNotFoundError(f"no safetensors weights in {folder}")


def load_component_state(folder: str, module: nn.Module,
                         variant: Optional[str] = "fp16") -> nn.Module:
    """Copy a component folder's tensors into `module`'s state dict, each
    cast to the dtype of the parameter or buffer it fills (int8 codes and
    their fp32 scales keep theirs), on its device; a file in JAX's
    canonical layout is laid out as torch's first.  Strict: a missing,
    unexpected or misshapen key raises."""
    targets = module.state_dict(keep_vars=True)
    seen = set()
    files = [SafetensorsFile(p) for p in _find_weights(folder, variant)]
    try:
        for f in files:
            canonical = f.metadata.get("sdtpu_layout") == "canonical"
            for name in f.keys():
                if name.endswith("position_ids"):
                    continue
                if name not in targets:
                    raise KeyError(f"{folder}: unexpected tensor {name!r}")
                t = f.torch_tensor(name)
                if canonical:
                    t = to_torch_layout(name, t)
                if tuple(t.shape) != tuple(targets[name].shape):
                    raise ValueError(f"{folder}: {name} has shape {tuple(t.shape)}, "
                                     f"the module {tuple(targets[name].shape)}")
                with torch.no_grad():
                    targets[name].copy_(t)
                seen.add(name)
    finally:
        for f in files:
            f.close()
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"{folder}: {len(missing)} tensors missing, e.g. {missing[:5]}")
    return module


def _component_keys(folder: str, variant: Optional[str] = "fp16") -> set:
    """The tensor names of a component folder (its files' headers only)."""
    keys = set()
    for p in _find_weights(folder, variant):
        with SafetensorsFile(p) as f:
            keys.update(f.keys())
    return keys


def _empty_module(cls, config, device: torch.device, dtype: torch.dtype,
                  state_keys=()) -> nn.Module:
    """An uninitialised `cls(config)` on `device` in `dtype`; where
    `state_keys` holds ``<path>.weight_int8``, with the int8 layer in place
    of the floating-point one, which is never allocated."""
    with torch.device("meta"):
        module = cls(config).to(dtype)
    swap_in_int8_layers(module, state_keys)
    return module.to_empty(device=device).eval().requires_grad_(False)


def _load_component(folder: str, cls, config, device: torch.device, dtype: torch.dtype,
                    variant: Optional[str] = "fp16") -> nn.Module:
    """A component folder loaded into a new `cls(config)`, int8 layers
    included (:func:`_empty_module`)."""
    return load_component_state(
        folder, _empty_module(cls, config, device, dtype, _component_keys(folder, variant)),
        variant)


# converter --scheduler_type choice -> serving registry name
_CONVERTER_SCHEDULER_NAMES = {
    "ddim": "DDIM",
    "pndm": "PNDM",
    "lms": "lms",
    "heun": "heun",
    "euler": "euler",
    "euler-ancestral": "euler_a",
    "dpm": "DPM++ 2M",
}


def _resolve_scheduler_name(path: str, scheduler_name: Optional[str]) -> str:
    """None means auto: a folder's recorded ``_scheduler_type``
    (model_index.json) before the DDIM default."""
    if scheduler_name is not None:
        return scheduler_name
    idx = os.path.join(path, "model_index.json")
    if os.path.exists(idx):
        stype = _read_json(idx).get("_scheduler_type")
        if stype:
            return _CONVERTER_SCHEDULER_NAMES.get(stype, stype)
    return "DDIM"


def _read_quant_mode(path: str) -> Optional[str]:
    """The int8 mode an int8 folder records in model_index.json, else None."""
    idx = os.path.join(path, "model_index.json")
    if os.path.exists(idx):
        return _read_json(idx).get("_sdtpu_quant")
    return None


def load_unet(path: str, device: torch.device, dtype: torch.dtype):
    """(config, module) of a folder's ``unet/`` on `device` in `dtype`: the
    refiner's loader (``SDModel.load_refiner``)."""
    folder = os.path.join(path, "unet")
    cfg = UNetConfig.from_diffusers_dict(_read_json(os.path.join(folder, "config.json")))
    return cfg, _load_component(folder, UNet2DConditionModel, cfg, device, dtype)


def load_sd_model(
    path: str,
    model_type: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    variant: Optional[str] = "fp16",
    scheduler_name: Optional[str] = None,
) -> SDModel:
    """Load a diffusers-layout SD1.x, SD2.x or SDXL folder onto `device`
    (default ``cuda``; raises without a card unless ``device="cpu"``).
    `model_type` None means "sdxl" when the folder has ``text_encoder_2/``,
    else "sd15" (an SD2.x folder loads as "sd15", as in JAX).  The UNet is
    held in `dtype` (default: the device's compute dtype), the VAE in fp32
    for SDXL (its decode runs in fp32) and in `dtype` otherwise, the text
    encoders in fp32, as ``utils/testing.random_full_model`` holds them.
    An int8 folder gives a ``quant_frozen`` model at the recorded mode."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    if os.path.isfile(path):
        raise ValueError(f"{path} is a single file: load it with load_sd_single_file")
    if model_type is None:
        model_type = "sdxl" if os.path.isdir(os.path.join(path, "text_encoder_2")) else "sd15"
    if model_type == "sd3":
        raise ValueError(f"{path}: an SD3 folder loads with load_sd3_model")
    if model_type not in ("sd15", "sdxl"):
        raise NotImplementedError(f"model type {model_type!r}: not an SD1.x, SD2.x or SDXL folder")
    scheduler_name = _resolve_scheduler_name(path, scheduler_name)
    vae_dtype = torch.float32 if model_type == "sdxl" else dtype

    unet_cfg = UNetConfig.from_diffusers_dict(_read_json(os.path.join(path, "unet", "config.json")))
    vae_cfg = VAEConfig.from_diffusers_dict(_read_json(os.path.join(path, "vae", "config.json")))
    te_cfg = CLIPTextConfig.from_diffusers_dict(
        _read_json(os.path.join(path, "text_encoder", "config.json")))
    sched_path = os.path.join(path, "scheduler", "scheduler_config.json")
    sched_cfg = (SchedulerConfig.from_diffusers_dict(_read_json(sched_path))
                 if os.path.exists(sched_path) else SchedulerConfig())

    def _load(sub, cls, config, dt):
        return _load_component(os.path.join(path, sub), cls, config, device, dt, variant)

    sdxl = {}
    if model_type == "sdxl":
        te2_cfg = CLIPTextConfig.from_diffusers_dict(
            _read_json(os.path.join(path, "text_encoder_2", "config.json")))
        sdxl = dict(
            text_encoder_2_config=te2_cfg,
            text_encoder_2=_load("text_encoder_2", CLIPTextModel, te2_cfg, torch.float32),
            tokenizer_2=CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer_2")),
        )
    qmode = _read_quant_mode(path)
    return SDModel(
        unet_config=unet_cfg,
        unet=_load("unet", UNet2DConditionModel, unet_cfg, dtype),
        quant_mode=qmode,
        quant_frozen=qmode is not None,
        vae_config=vae_cfg,
        vae=_load("vae", AutoencoderKL, vae_cfg, vae_dtype),
        text_encoder_config=te_cfg,
        text_encoder=_load("text_encoder", CLIPTextModel, te_cfg, torch.float32),
        tokenizer=CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer")),
        scheduler_config=sched_cfg,
        scheduler_name=scheduler_name,
        model_type=model_type,
        path=path,
        **sdxl,
    )


def load_sd3_model(
    path: str,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
    variant: Optional[str] = "fp16",
    scheduler_name: str = "FlowMatchEuler",
) -> SD3Model:
    """Load a diffusers-layout SD3-family folder (``transformer/``, ``vae/``,
    CLIP-L and bigG with their tokenizers; ``text_encoder_3/`` and
    ``tokenizer_3/`` optional, the T5-free serving configuration) onto
    `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``).  Every component is held in `dtype` (default: the
    device's compute dtype), as ``utils/testing.random_full_model("sd3")``
    holds them; the pipeline runs the VAE's encode and decode in fp32.  An
    int8 folder gives a ``quant_frozen`` model at the recorded mode."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    if os.path.isfile(path):
        raise ValueError("SD3 single-file checkpoints are not supported; "
                         "provide a diffusers-layout folder")

    def cfg(cls, sub):
        return cls.from_diffusers_dict(_read_json(os.path.join(path, sub, "config.json")))

    def _load(sub, cls, config):
        return _load_component(os.path.join(path, sub), cls, config, device, dtype, variant)

    sched_path = os.path.join(path, "scheduler", "scheduler_config.json")
    sched_cfg = (SchedulerConfig.from_diffusers_dict(_read_json(sched_path))
                 if os.path.exists(sched_path) else SchedulerConfig(shift=3.0))
    tf_cfg, vae_cfg = cfg(SD3Config, "transformer"), cfg(VAEConfig, "vae")
    te_cfg, te2_cfg = cfg(CLIPTextConfig, "text_encoder"), cfg(CLIPTextConfig, "text_encoder_2")
    t5 = {}
    if os.path.exists(os.path.join(path, "text_encoder_3", "config.json")):
        t5_cfg = cfg(T5Config, "text_encoder_3")
        t5 = dict(text_encoder_3_config=t5_cfg,
                  text_encoder_3=_load("text_encoder_3", T5EncoderModel, t5_cfg),
                  tokenizer_3=SentencePieceUnigramTokenizer.from_pretrained(
                      os.path.join(path, "tokenizer_3")))
    qmode = _read_quant_mode(path)
    return SD3Model(
        transformer_config=tf_cfg,
        transformer=_load("transformer", SD3Transformer2DModel, tf_cfg),
        quant_mode=qmode,
        quant_frozen=qmode is not None,
        vae_config=vae_cfg,
        vae=_load("vae", AutoencoderKL, vae_cfg),
        text_encoder_config=te_cfg,
        text_encoder=_load("text_encoder", CLIPTextModel, te_cfg),
        tokenizer=CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer")),
        text_encoder_2_config=te2_cfg,
        text_encoder_2=_load("text_encoder_2", CLIPTextModel, te2_cfg),
        tokenizer_2=CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer_2")),
        scheduler_config=sched_cfg,
        scheduler_name=scheduler_name,
        path=path,
        **t5,
    )


@contextlib.contextmanager
def read_single_file(path: str) -> Iterator[Dict[str, np.ndarray]]:
    """The tensors of a single-file checkpoint as numpy arrays, valid inside
    the block (``io/convert_cli.load_single_file``): a .safetensors file
    through views of its mmap (bfloat16 tensors as fp32 copies), a .ckpt
    through ``torch.load(weights_only=True)``, its ``state_dict`` unwrapped."""
    if path.endswith(".safetensors"):
        from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile

        with SafetensorsFile(path) as f:
            yield {k: (f.tensor(k) if f.dtype_str(k) != "BF16"
                       else f.torch_tensor(k).float().numpy()) for k in f.keys()}
        return
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    yield {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
           for k, v in state.items() if isinstance(v, torch.Tensor)}


def _fill(module: nn.Module, flat: Mapping[str, np.ndarray], what: str) -> nn.Module:
    """Copy converted tensors (diffusers names, torch layouts) into
    `module`, each cast to its parameter's dtype.  Strict, as
    :func:`load_component_state`."""
    targets = module.state_dict(keep_vars=True)
    flat = {k: v for k, v in flat.items() if not k.endswith("position_ids")}
    missing, unexpected = sorted(set(targets) - set(flat)), sorted(set(flat) - set(targets))
    if missing or unexpected:
        raise KeyError(f"{what}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, arr in flat.items():
            if tuple(arr.shape) != tuple(targets[name].shape):
                raise ValueError(f"{what}: {name} has shape {tuple(arr.shape)}, "
                                 f"the module {tuple(targets[name].shape)}")
            targets[name].copy_(torch.from_numpy(np.array(arr)))
    return module


def load_sd_single_file(
    path: str,
    scheduler_name: str = "DDIM",
    tokenizer_dir: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    extract_ema: bool = False,
    scaling_factor: Optional[float] = None,
    prediction_type: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
    config_overrides: Optional[Mapping[str, Mapping]] = None,
) -> SDModel:
    """An A1111/LDM single-file checkpoint (.safetensors or .ckpt) as an
    SDModel on `device` (default ``cuda``), converted in memory by
    ``io/a1111.convert_a1111_checkpoint``.  Dtypes as :func:`load_sd_model`.
    `tokenizer_dir` holds ``tokenizer/`` (and for SDXL ``tokenizer_2/``;
    without it the second tower reuses the first's files with OpenCLIP's pad
    "!" = id 0) or the vocab and merges files themselves; single files carry
    no tokenizer, and without one the model runs from prompt embeddings
    only.  `prediction_type` is not recorded in the file: v-prediction
    checkpoints need it.  `config_overrides` ({"unet" | "vae" |
    "text_encoder" | "text_encoder_2": {field: value}}) sets what the
    tensors' shapes do not tell (head counts, norm groups): the port builds
    its modules from the configs, where the JAX package may replace a
    config after loading."""
    from stablediffusion_tpu_torch.io.a1111 import convert_a1111_checkpoint

    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    overrides = config_overrides or {}

    def tok(sub: str):
        if tokenizer_dir is None:
            return None
        d = os.path.join(tokenizer_dir, sub)
        if not os.path.isdir(d):
            if sub == "tokenizer_2":
                # CLIP-L and OpenCLIP-bigG share vocab and merges; only the
                # pad differs ("!" = id 0 for the second tower)
                d = os.path.join(tokenizer_dir, "tokenizer")
                if not os.path.isdir(d):
                    d = tokenizer_dir
                return CLIPTokenizer.from_pretrained(d, pad_token_id=0)
            d = tokenizer_dir
        return CLIPTokenizer.from_pretrained(d)

    if tokenizer_dir is None:
        logger.warning("single-file checkpoint has no tokenizer; pass tokenizer_dir= "
                       "or supply prompt_embeds at generation time")

    def cfg(cls, comp: str, d: dict):
        return dataclasses.replace(cls.from_diffusers_dict(d), **overrides.get(comp, {}))

    with read_single_file(path) as state:
        weights, configs = convert_a1111_checkpoint(
            state, extract_ema_weights=extract_ema, scaling_factor=scaling_factor)
        is_sdxl = configs["model_type"] == "sdxl"
        unet_cfg = cfg(UNetConfig, "unet", configs["unet"])
        vae_cfg = cfg(VAEConfig, "vae", configs["vae"])
        te_cfg = cfg(CLIPTextConfig, "text_encoder", configs["text_encoder"])

        def build(comp, cls, config, dt):
            return _fill(_empty_module(cls, config, device, dt), weights.pop(comp),
                         f"{path} {comp}")

        sdxl = {}
        if is_sdxl:
            te2_cfg = cfg(CLIPTextConfig, "text_encoder_2", configs["text_encoder_2"])
            sdxl = dict(text_encoder_2_config=te2_cfg,
                        text_encoder_2=build("text_encoder_2", CLIPTextModel, te2_cfg,
                                             torch.float32),
                        tokenizer_2=tok("tokenizer_2"))
        model = SDModel(
            unet_config=unet_cfg,
            unet=build("unet", UNet2DConditionModel, unet_cfg, dtype),
            vae_config=vae_cfg,
            vae=build("vae", AutoencoderKL, vae_cfg, torch.float32 if is_sdxl else dtype),
            text_encoder_config=te_cfg,
            text_encoder=build("text_encoder", CLIPTextModel, te_cfg, torch.float32),
            tokenizer=tok("tokenizer"),
            scheduler_config=(SchedulerConfig(prediction_type=prediction_type)
                              if prediction_type else SchedulerConfig()),
            scheduler_name=scheduler_name,
            model_type="sdxl" if is_sdxl else "sd15",
            path=os.path.abspath(path),
            **sdxl,
        )
        del state, weights  # views of the file's mmap, which closes next
    return model


def _dump_component(path: str, sub: str, module: Union[nn.Module, Mapping[str, torch.Tensor]],
                    cfg_dict: dict, fname: str = "diffusion_pytorch_model",
                    variant: Optional[str] = None,
                    quant_mode: Optional[str] = None) -> None:
    """One diffusers component folder: safetensors of the state dict (a
    module's, or one given) in its dtypes, plus config.json.  With
    `quant_mode`, every tensor goes in JAX's canonical layout and the file
    is stamped ``sdtpu_layout: canonical`` and ``sdtpu_quant``."""
    d = os.path.join(path, sub)
    os.makedirs(d, exist_ok=True)
    suffix = f".{variant}" if variant else ""
    state = module.state_dict() if isinstance(module, nn.Module) else module
    metadata = None
    if quant_mode:
        state = {k: to_jax_layout(k, v).contiguous() for k, v in state.items()}
        metadata = {"sdtpu_layout": "canonical", "sdtpu_quant": quant_mode}
    save_safetensors(state, os.path.join(d, f"{fname}{suffix}.safetensors"), metadata=metadata)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)


def _check_fp_save(model, quantize: Optional[str]) -> None:
    """A floating-point save of a model quantized in memory would write
    int8 layers in the torch layout: refuse it."""
    if quantize is None and model.quant_mode is not None:
        raise ValueError(
            f"model is int8-quantized in memory; pass quantize={model.quant_mode!r} to write "
            "an int8 checkpoint, or model.quantize(None) first for an fp ecosystem checkpoint")


def _quantized_tree(model, mode: str) -> Dict[str, torch.Tensor]:
    """The denoise tower's state dict at int8 `mode`: the model's own when
    it is quantized so, else quantized afresh from its floating-point
    weights (the model is left as it is)."""
    if model.quant_mode not in (None, mode):
        raise ValueError(
            f"cannot write a {mode!r} checkpoint from a model quantized as "
            f"{model.quant_mode!r}; load fp weights or model.quantize(None)")
    tower = getattr(model, model.TOWER)
    state = dict(tower.state_dict())
    if model.quant_mode == mode:
        return state
    plan = quantize_plan(tower, mode, min_size=model.quant_min_size,
                         skip_keys=model._QUANT_SKIP)
    with torch.no_grad():
        for path, leaf_mode in plan.items():
            q = quantized_layer(tower.get_submodule(path), leaf_mode)
            del state[f"{path}.weight"]
            state[f"{path}.weight_int8"] = q.weight_int8
            state[f"{path}.{leaf_mode}_scale"] = q.scale
    return state


def save_sd_model(model: SDModel, path: str, variant: Optional[str] = None,
                  quantize: Optional[str] = None) -> None:
    """Write a diffusers-layout folder that ``load_sd_model`` (and the JAX
    package's) reads back: per-component safetensors and configs (SDXL's
    second tower too), the tokenizers, the scheduler config, and
    model_index.json naming the pipeline class and the active scheduler.
    The refiner is not written, as in JAX: it has its own folder.

    `quantize` ("w8" | "w8a8" | "w8a8:N" | "auto", the batch-1 mode) writes
    the UNet as an int8 folder (the module docstring), which loads
    ``quant_frozen``."""
    quantize = resolve_quant_mode(quantize)
    _check_fp_save(model, quantize)
    os.makedirs(path, exist_ok=True)
    _dump_component(path, "unet",
                    _quantized_tree(model, quantize) if quantize else model.unet,
                    _unet_cfg_dict(model.unet_config), variant=variant, quant_mode=quantize)
    _dump_component(path, "vae", model.vae, _vae_cfg_dict(model.vae_config), variant=variant)
    _dump_component(path, "text_encoder", model.text_encoder,
                    _clip_cfg_dict(model.text_encoder_config), fname="model", variant=variant)
    if model.is_sdxl:
        _dump_component(path, "text_encoder_2", model.text_encoder_2,
                        _clip_cfg_dict(model.text_encoder_2_config), fname="model",
                        variant=variant)
    if hasattr(model.tokenizer, "save_pretrained"):
        model.tokenizer.save_pretrained(os.path.join(path, "tokenizer"))
    if model.is_sdxl and hasattr(model.tokenizer_2, "save_pretrained"):
        model.tokenizer_2.save_pretrained(os.path.join(path, "tokenizer_2"))
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(dataclasses.asdict(model.scheduler_config), f, indent=2)
    index = {"_class_name": ("StableDiffusionXLPipeline" if model.is_sdxl
                             else "StableDiffusionPipeline"),
             "_scheduler_type": model.scheduler_name}
    if quantize:
        index["_sdtpu_quant"] = quantize
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f)


def save_sd3_model(model: SD3Model, path: str, variant: Optional[str] = None,
                   quantize: Optional[str] = None) -> None:
    """Write a diffusers-layout SD3-family folder that ``load_sd3_model``
    (and the JAX package's) reads back: the transformer, the VAE and the
    text towers (T5 only when the model has one) with their configs and
    tokenizers, the scheduler config, and model_index.json.  `quantize`
    writes the MM-DiT as an int8 folder, as ``save_sd_model`` writes the
    UNet."""
    quantize = resolve_quant_mode(quantize)
    _check_fp_save(model, quantize)
    os.makedirs(path, exist_ok=True)
    tf_cfg = dataclasses.asdict(model.transformer_config)
    tf_cfg["dual_attention_layers"] = list(tf_cfg["dual_attention_layers"])
    tf_cfg["_class_name"] = "SD3Transformer2DModel"
    _dump_component(path, "transformer",
                    _quantized_tree(model, quantize) if quantize else model.transformer,
                    tf_cfg, variant=variant, quant_mode=quantize)
    _dump_component(path, "vae", model.vae, _vae_cfg_dict(model.vae_config), variant=variant)
    for sub in ("text_encoder", "text_encoder_2"):
        _dump_component(path, sub, getattr(model, sub),
                        _clip_cfg_dict(getattr(model, f"{sub}_config")), fname="model",
                        variant=variant)
    tokenizers = [("tokenizer", model.tokenizer), ("tokenizer_2", model.tokenizer_2)]
    if model.text_encoder_3 is not None:
        t5_cfg = dataclasses.asdict(model.text_encoder_3_config)
        t5_cfg["architectures"] = ["T5EncoderModel"]
        _dump_component(path, "text_encoder_3", model.text_encoder_3, t5_cfg, fname="model",
                        variant=variant)
        tokenizers.append(("tokenizer_3", model.tokenizer_3))
    for sub, tok in tokenizers:
        if hasattr(tok, "save_pretrained"):
            tok.save_pretrained(os.path.join(path, sub))
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(dataclasses.asdict(model.scheduler_config), f, indent=2)
    index = {"_class_name": "StableDiffusion3Pipeline"}
    if quantize:
        index["_sdtpu_quant"] = quantize
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f)


def load_controlnet(path: str, device: torch.device, dtype: torch.dtype):
    """(config, module) of a diffusers-layout ControlNet folder, `path` or
    its ``controlnet/`` subfolder, on `device` in `dtype`."""
    from stablediffusion_tpu_torch.models.controlnet import ControlNetModel

    if not os.path.exists(os.path.join(path, "config.json")):
        path = os.path.join(path, "controlnet")
    cfg = UNetConfig.from_diffusers_dict(_read_json(os.path.join(path, "config.json")))
    return cfg, _load_component(path, ControlNetModel, cfg, device, dtype)


def save_controlnet(controlnet: Union[nn.Module, Mapping[str, torch.Tensor]],
                    config: UNetConfig, path: str) -> None:
    """Write a diffusers-layout ControlNet folder (ControlNetModel's
    save_pretrained layout): the state dict in its dtypes and config.json,
    which :func:`load_controlnet` and the JAX package's ``load_controlnet``
    read back."""
    cfg = _unet_cfg_dict(config)
    cfg["_class_name"] = "ControlNetModel"
    _dump_component(path, "", controlnet, cfg)


def load_image_encoder(path: str, device: torch.device, dtype: torch.dtype):
    """(config, module) of a transformers-layout CLIP vision folder, `path`
    or its ``image_encoder/`` subfolder, on `device` in `dtype`."""
    from stablediffusion_tpu_torch.models.clip_vision import CLIPVisionModel

    if os.path.isdir(os.path.join(path, "image_encoder")):
        path = os.path.join(path, "image_encoder")
    cfg = CLIPVisionConfig.from_diffusers_dict(_read_json(os.path.join(path, "config.json")))
    return cfg, _load_component(path, CLIPVisionModel, cfg, device, dtype)


def save_image_encoder(encoder: nn.Module, config: CLIPVisionConfig, path: str) -> None:
    """Write an ``image_encoder`` folder: ``model.safetensors`` and a
    transformers config.json."""
    cfg = dataclasses.asdict(config)
    cfg["architectures"] = ["CLIPVisionModelWithProjection" if config.with_projection
                            else "CLIPVisionModel"]
    _dump_component(path, "", encoder, cfg, fname="model")


def _unet_cfg_dict(c: UNetConfig) -> dict:
    d = dataclasses.asdict(c)
    d["down_block_types"] = list(c.down_block_types)
    d["up_block_types"] = list(c.up_block_types)
    d["block_out_channels"] = list(c.block_out_channels)
    if isinstance(c.num_attention_heads, tuple):
        d["num_attention_heads"] = list(c.num_attention_heads)
    if isinstance(c.transformer_layers_per_block, tuple):
        d["transformer_layers_per_block"] = list(c.transformer_layers_per_block)
    return d


def _vae_cfg_dict(c: VAEConfig) -> dict:
    d = dataclasses.asdict(c)
    d["block_out_channels"] = list(c.block_out_channels)
    return d


def _clip_cfg_dict(c: CLIPTextConfig) -> dict:
    d = dataclasses.asdict(c)
    d["architectures"] = [
        "CLIPTextModelWithProjection" if c.with_projection else "CLIPTextModel"
    ]
    return d
