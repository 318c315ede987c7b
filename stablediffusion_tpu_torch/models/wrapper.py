"""SDModel — configs, modules, tokenizers, scheduler and adapters of one model.

Port of ``stablediffusion_tpu/models/wrapper.py``: the holder (:29-85), its
``reload`` (:87-115), ``load_refiner`` (:132-152), textual inversion
(:194-374), the LoRA adapter lifecycle (:460-561), the ControlNet
(``load_controlnet`` :117) and IP-Adapter with its image encoder
(``load_ip_adapter`` :156-192, ``load_image_encoder`` :376).  The JAX holder pairs
configs with param trees; here it pairs them with ``nn.Module``s, all on
one device.  SDXL is told by the presence of the second text tower
(``text_encoder_2``, bigG, with its ``tokenizer_2``); an SDXL model may also
hold a refiner UNet.  The scheduler switches by name over the shared config
(``set_scheduler``); checkpoints load and save through ``io/loader.py``.

Adapters and int8 quantization share one lifecycle with ``SD3Model``
(:class:`AdapterHolder`, JAX ``wrapper.py:396-561`` and ``pipelines/
sd3.py:98-255``).  Adapters fuse into the modules in place
(``lora/core.write_fused``): the first fusion that touches a weight keeps a
pristine copy of it on the model's device, every later one fuses from those
copies, and ``delete_adapters`` copies them back, so the weights come back
bit for bit.  ``quantize`` swaps int8 modules into the denoise tower after
every fusion (``ops/quant.quantize_params``) and keeps the floating-point
modules they replaced, which hold the fused weights: fusion and
``quantize(None)`` swap them back first.  A model loaded from an int8
folder holds no floating-point tower (``quant_frozen``): it refuses fusion
and re-quantization.  Textual inversion appends rows to the token-embedding
tables, which no adapter touches, so re-fusing keeps them.

An IP-Adapter's ``to_k_ip`` / ``to_v_ip`` are linears added to the UNet's
cross-attentions (``models/ip_adapter.fuse_ip_weights``) inside the same
lifecycle: LoRA fusion leaves them as they are, ``quantize`` plans them as
JAX's ``_maybe_quantize`` plans its IP-fused base (by path and size), and
``unload_ip_adapter`` removes them, which gives back the UNet's modules and
tensors as they were.  The ControlNet is held in the UNet's dtype, the image
encoder in fp32 as the text towers; JAX keeps each file's stored dtypes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from stablediffusion_tpu_torch.lora.core import fuse, linear_module_paths, restore, write_fused
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.ops.quant import (
    DEFAULT_SKIP_KEYS,
    quantize_params,
    resolve_quant_mode,
    swap_modules,
    validate_quant_mode,
)
from stablediffusion_tpu_torch.schedulers import make_scheduler

# the modules LoRA adapters fuse into, by the component names of LoRA files
LORA_COMPONENTS = ("unet", "text_encoder", "text_encoder_2")


@dataclass(kw_only=True)
class AdapterHolder:
    """The LoRA adapter and int8 lifecycle of a model holder.  A subclass
    names its denoise tower (``TOWER``: the LoRA component and attribute,
    "unet" or "transformer"), the quantizer's skip list (``_QUANT_SKIP``) and
    its LoRA modules (``_lora_modules``)."""

    TOWER = "unet"
    _QUANT_SKIP = DEFAULT_SKIP_KEYS

    # active adapters (name -> scale) and the loaded ones (name ->
    # {component: {module path: factors on the model's device}})
    adapters: Dict[str, float] = field(default_factory=dict)
    # the tower's int8 mode ("w8" | "w8a8" | "w8a8:N" | None); it survives
    # adapter swaps, which quantize again after fusing
    quant_mode: Optional[str] = None
    quant_min_size: int = 65536
    # loaded from an int8 folder: there is no floating-point tower, so
    # re-quantization and LoRA fusion raise
    quant_frozen: bool = False
    # per-instance state, which dataclasses.replace does not share
    _adapter_store: Dict[str, Dict[str, dict]] = field(default_factory=dict, init=False,
                                                       repr=False)
    # component -> {"<path>.weight": the original of each fused weight}
    _pristine: Dict[str, Dict[str, torch.Tensor]] = field(default_factory=dict, init=False,
                                                          repr=False)
    # the tower's floating-point modules that int8 ones replace, by path
    _fp_modules: Dict[str, nn.Module] = field(default_factory=dict, init=False, repr=False)

    def _lora_modules(self) -> Dict[str, nn.Module]:
        raise NotImplementedError

    def _check_not_frozen(self, op: str) -> None:
        if self.quant_frozen:
            raise ValueError(
                f"{op} requires fp weights, but this model was loaded from an int8-quantized "
                "checkpoint (no fp base on disk); load the original fp checkpoint instead")

    @contextlib.contextmanager
    def _fp_tower(self):
        """The tower with its floating-point modules in place inside the
        block; quantized again after it, from their weights, at the model's
        mode then."""
        tower = getattr(self, self.TOWER)
        if self._fp_modules:
            swap_modules(tower, self._fp_modules)
            self._fp_modules = {}
        try:
            yield
        finally:
            self._maybe_quantize()

    def _maybe_quantize(self) -> None:
        """Quantize the tower at the model's mode, keeping the
        floating-point modules that the int8 ones replace."""
        if self.quant_mode is not None and not self.quant_frozen:
            self._fp_modules = quantize_params(
                getattr(self, self.TOWER), self.quant_mode, min_size=self.quant_min_size,
                skip_keys=self._QUANT_SKIP)

    def quantize(self, mode: Optional[str] = "w8a8", min_size: Optional[int] = None,
                 expected_batch: int = 1) -> None:
        """Opt-in int8 quantization of the tower: "w8", "w8a8", "w8a8:N"
        (int8 GEMMs for layers of at least N output channels, "w8" for the
        others) or "auto", the mode ``ops/quant.resolve_quant_mode`` picks
        for `expected_batch` (``quant_mode`` keeps the resolved string).
        None goes back to the floating-point weights, fused adapters kept.
        Approximate: the skip list's layers stay floating point."""
        self._check_not_frozen("quantize()")
        validate_quant_mode(mode)  # before any state changes
        mode = resolve_quant_mode(mode, expected_batch)
        with self._fp_tower():
            self.quant_mode = mode
            if min_size is not None:
                self.quant_min_size = int(min_size)

    def get_list_adapters(self) -> Dict[str, float]:
        return dict(self.adapters)

    def lora_module_paths(self) -> Dict[str, List[str]]:
        """Every linear-module path per component: the resolver table for
        kohya's underscore-flattened LoRA keys (``lora/formats.py``); the
        tower's int8 linears count by their floating-point modules."""
        paths = {c: linear_module_paths(m, ("",)) for c, m in self._lora_modules().items()}
        fp = [p for p, m in self._fp_modules.items() if isinstance(m, nn.Linear)]
        if fp:
            paths[self.TOWER] = sorted(set(paths[self.TOWER]) | set(fp))
        return paths

    def load_lora_weights(self, name: str, adapter: Dict[str, Dict[str, dict]]) -> None:
        """Register a parsed adapter ({component: {module path: factors}})
        under `name`, its factors moved to the model's device in fp32."""
        self._check_not_frozen("LoRA fusion")
        self._adapter_store[name] = {
            comp: {path: {k: v.to(self.device, torch.float32) for k, v in f.items()}
                   for path, f in tree.items()}
            for comp, tree in adapter.items()}

    def set_adapters(self, weights: Dict[str, float]) -> None:
        """Fuse the named adapters at the given scales into the modules, in
        place of any earlier fusion (fused from the pristine copies), then
        quantize the tower again at the model's mode."""
        self._check_not_frozen("LoRA fusion")
        unknown = [n for n in weights if n not in self._adapter_store]
        if unknown:
            raise ValueError(f"unknown adapters {unknown}; loaded: "
                             f"{sorted(self._adapter_store)}")
        with self._fp_tower():
            for comp, module in self._lora_modules().items():
                pristine = self._pristine.setdefault(comp, {})
                comp_adapters = {n: self._adapter_store[n][comp] for n in weights
                                 if comp in self._adapter_store[n]}
                fused = (fuse(module, comp_adapters, weights, base=pristine)
                         if comp_adapters else {})
                write_fused(module, fused, pristine)
        self.adapters = dict(weights)

    def delete_adapters(self) -> None:
        """Drop every adapter and restore the original weights bit for bit."""
        if self._pristine:
            with self._fp_tower():
                modules = self._lora_modules()
                for comp, pristine in self._pristine.items():
                    restore(modules[comp], pristine)
        self._pristine = {}
        self._adapter_store = {}
        self.adapters = {}

    def load_loras(self, loras, lora_dir: Optional[str] = None) -> None:
        """A name, a list of names or {name: scale}: read each file
        ``{lora_dir}/{model_type}_{name}.safetensors`` and fuse them all, in
        place of the adapters fused before.  A frozen int8 model refuses
        before it reads a file."""
        from stablediffusion_tpu_torch.lora.formats import load_lora_file

        self._check_not_frozen("LoRA fusion")
        if isinstance(loras, str):
            loras = {loras: 1.0}
        elif isinstance(loras, (list, tuple)):
            loras = {n: 1.0 for n in loras}
        self.delete_adapters()
        model_paths = None
        for name in loras:
            path = os.path.join(lora_dir or ".", f"{self.model_type}_{name}.safetensors")
            if model_paths is None:
                model_paths = self.lora_module_paths()
            self.load_lora_weights(name, load_lora_file(path, model_paths))
        self.set_adapters(dict(loras))


@dataclass
class SDModel(AdapterHolder):
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
    path: Optional[str] = None  # the checkpoint folder or single file it came from
    # SDXL's second tower (its presence makes the model SDXL, as in JAX)
    text_encoder_2_config: Optional[CLIPTextConfig] = None
    text_encoder_2: Optional[CLIPTextModel] = None
    tokenizer_2: Any = None
    # the SDXL refiner's UNet, loaded on demand (load_refiner)
    refiner_config: Optional[UNetConfig] = None
    refiner: Optional[UNet2DConditionModel] = None
    # ControlNet (load_controlnet), IP-Adapter (load_ip_adapter: its image
    # projection, a models/ip_adapter.IPAdapter) and the image encoder
    controlnet_config: Optional[UNetConfig] = None
    controlnet: Optional[nn.Module] = None
    ip_adapter: Optional[Any] = None
    ip_scale: float = 1.0
    image_encoder_config: Optional[CLIPVisionConfig] = None
    image_encoder: Optional[nn.Module] = None
    _scheduler: Optional[Any] = field(default=None, repr=False)
    # textual inversion: each table's original row count, trigger -> towers
    _ti_state: Optional[Dict[str, Any]] = field(default=None, init=False, repr=False)

    def __post_init__(self):
        modules = (self.unet, self.vae, self.text_encoder, self.text_encoder_2, self.refiner,
                   self.controlnet, self.image_encoder)
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

    def load_controlnet(self, path: str) -> None:
        """Load a diffusers-layout ControlNet folder (`path`, or its
        ``controlnet/`` subfolder) onto the model's device in the UNet's
        dtype."""
        from stablediffusion_tpu_torch.io.loader import load_controlnet

        dtype = next(self.unet.parameters()).dtype
        self.controlnet_config, self.controlnet = load_controlnet(path, self.device, dtype)

    # -- IP-Adapter (wrapper.py:156-192, :376) --------------------------------
    def load_ip_adapter(self, path: str, image_encoder_path: Optional[str] = None) -> None:
        """Load an IP-Adapter checkpoint (.safetensors or .bin with
        ``image_proj`` and ``ip_adapter`` groups): its image projection on
        the model's device and its decoupled cross-attention projections
        added to the UNet, both in the UNet's dtype; the fused LoRAs stay and
        the UNet is quantized again at the model's mode.  A loaded adapter
        is replaced."""
        from stablediffusion_tpu_torch.models.ip_adapter import (
            IPAdapter,
            fuse_ip_weights,
            strip_ip_weights,
        )

        dtype = next(self.unet.parameters()).dtype
        adapter, ip_sd = IPAdapter.load(path, self.device, dtype)
        with self._fp_tower():
            strip_ip_weights(self.unet)
            fuse_ip_weights(self.unet, self.unet_config, ip_sd)
        self.ip_adapter = adapter
        if image_encoder_path is not None:
            self.load_image_encoder(image_encoder_path)

    def set_ip_adapter_scale(self, scale: float) -> None:
        self.ip_scale = float(scale)

    def unload_ip_adapter(self) -> None:
        """Remove the IP-Adapter's projections from the UNet (quantized
        again at the model's mode) and drop its image projection."""
        from stablediffusion_tpu_torch.models.ip_adapter import strip_ip_weights

        with self._fp_tower():
            strip_ip_weights(self.unet)
        self.ip_adapter = None

    def load_image_encoder(self, path: str) -> None:
        """Load a CLIP vision tower (a transformers-layout ``image_encoder``
        folder, or the folder holding one) onto the model's device in
        fp32."""
        from stablediffusion_tpu_torch.io.loader import load_image_encoder

        self.image_encoder_config, self.image_encoder = load_image_encoder(
            path, self.device, torch.float32)

    def reload(self) -> "SDModel":
        """Re-read the checkpoint this model came from (a folder or a single
        file), dropping adapters, textual inversions and the refiner.  A
        single file keeps its tokenizers and configs (it carries neither
        tokenizer nor head counts), its prediction type and the UNet's
        dtype."""
        if not self.path:
            raise ValueError("model has no checkpoint path to reload from")
        from stablediffusion_tpu_torch.io.loader import load_sd_model, load_sd_single_file

        self.unload_textual_inversion()
        dtype = next(self.unet.parameters()).dtype
        if os.path.isfile(self.path):
            configs = {"unet": self.unet_config, "vae": self.vae_config,
                       "text_encoder": self.text_encoder_config,
                       "text_encoder_2": self.text_encoder_2_config}
            fresh = load_sd_single_file(
                self.path, scheduler_name=self.scheduler_name, dtype=dtype,
                prediction_type=self.scheduler_config.prediction_type, device=self.device,
                config_overrides={k: dataclasses.asdict(c) for k, c in configs.items()
                                  if c is not None})
            fresh.tokenizer, fresh.tokenizer_2 = self.tokenizer, self.tokenizer_2
        else:
            fresh = load_sd_model(self.path, model_type=self.model_type, device=self.device,
                                  dtype=dtype, scheduler_name=self.scheduler_name)
        self.__dict__.update(fresh.__dict__)
        return self

    # -- textual inversion (wrapper.py:194-374) ------------------------------
    def _towers(self) -> Dict[str, tuple]:
        return {"text_encoder": (self.tokenizer, self.text_encoder),
                "text_encoder_2": (self.tokenizer_2, self.text_encoder_2)}

    def load_textual_inversion(self, source, token: Optional[str] = None,
                               allow_pickle: bool = False) -> str:
        """Load a learned embedding and register its trigger; returns the
        trigger.  Formats: diffusers ``{"<token>": [n, hidden]}``, A1111 .pt
        ``{"string_to_param": {"*": ...}, "name": ...}``, community
        ``{"emb_params": [n, hidden]}``, SDXL ``{"clip_l", "clip_g"}`` (an
        SDXL model needs this one).  `source` is a path (.safetensors, or a
        torch pickle read with ``weights_only=True``; full pickle, which can
        run code, only with `allow_pickle`) or a dict.  The rows are
        appended to each tower's token-embedding table as a new parameter
        of its dtype and device, and the trigger maps to their ids."""
        if isinstance(source, str):
            name_hint = os.path.splitext(os.path.basename(source))[0]
            if source.endswith(".safetensors"):
                from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile

                with SafetensorsFile(source) as f:
                    state = {k: f.torch_tensor(k).clone() for k in f.keys()}
            else:
                try:
                    state = torch.load(source, map_location="cpu", weights_only=True)
                except Exception:
                    if not allow_pickle:
                        raise ValueError(
                            f"{source!r} is not loadable with weights_only=True; pass "
                            "allow_pickle=True only for embedding files you trust (full "
                            "pickle deserialization can execute arbitrary code)")
                    state = torch.load(source, map_location="cpu", weights_only=False)
        else:
            state, name_hint = dict(source), None

        def rows(v) -> torch.Tensor:
            t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            t = t.detach().float()
            return t.reshape(1, -1) if t.dim() == 1 else t

        per_tower: Dict[str, torch.Tensor] = {}
        if "string_to_param" in state:  # A1111 .pt
            per_tower["text_encoder"] = rows(next(iter(state["string_to_param"].values())))
            token = token or state.get("name") or name_hint
        elif "emb_params" in state:
            per_tower["text_encoder"] = rows(state["emb_params"])
        elif "clip_l" in state or "clip_g" in state:  # SDXL
            if not self.is_sdxl:
                raise ValueError("clip_l/clip_g embedding needs an SDXL model")
            if "clip_l" not in state or "clip_g" not in state:
                raise ValueError("SDXL textual inversion needs BOTH clip_l and clip_g")
            per_tower["text_encoder"] = rows(state["clip_l"])
            per_tower["text_encoder_2"] = rows(state["clip_g"])
        else:  # diffusers: one {token: tensor}
            tensors = {k: v for k, v in state.items() if not isinstance(v, (str, int, float))}
            if len(tensors) != 1:
                raise ValueError(f"unrecognized embedding format: {sorted(state)}")
            tok_key, vec = next(iter(tensors.items()))
            token = token or tok_key
            per_tower["text_encoder"] = rows(vec)
        if self.is_sdxl and "text_encoder_2" not in per_tower:
            raise ValueError("this embedding has no clip_g vectors; an SDXL model needs "
                             "the dual-tower format")
        token = token or name_hint
        if not token:
            raise ValueError("no trigger token given and none in the file")
        towers = self._towers()
        for comp in per_tower:
            if towers[comp][0] is None:
                raise ValueError(
                    "textual inversion needs a tokenizer to register its trigger, but "
                    f"{comp}'s tokenizer is None (single-file load without tokenizer_dir?)")
        for comp, vec in per_tower.items():
            hidden = towers[comp][1].text_model.embeddings.token_embedding.weight.shape[1]
            if vec.shape[1] != hidden:
                raise ValueError(f"embedding dim {vec.shape[1]} != {comp} hidden {hidden}")

        if self._ti_state is None:
            self._ti_state = {"orig_rows": {}, "tokens": {}}
        for comp, vec in per_tower.items():
            tok, encoder = towers[comp]
            table = encoder.text_model.embeddings.token_embedding
            n = table.weight.shape[0]
            self._ti_state["orig_rows"].setdefault(comp, n)
            _set_table(table, torch.cat([table.weight.detach(), vec.to(table.weight)]))
            tok.add_tokens({token: list(range(n, n + vec.shape[0]))})
        self._ti_state["tokens"][token] = sorted(per_tower)
        return token

    def unload_textual_inversion(self) -> None:
        """Remove every loaded textual inversion: the tables go back to
        their original rows, the triggers are dropped."""
        if not self._ti_state:
            return
        towers = self._towers()
        for comp, n in self._ti_state["orig_rows"].items():
            tok, encoder = towers[comp]
            table = encoder.text_model.embeddings.token_embedding
            _set_table(table, table.weight.detach()[:n].clone())
            tok.clear_added_tokens()
        self._ti_state = None

    # -- LoRA adapters (wrapper.py:460-561) ----------------------------------
    def _lora_modules(self) -> Dict[str, nn.Module]:
        return {c: m for c, m in (("unet", self.unet), ("text_encoder", self.text_encoder),
                                  ("text_encoder_2", self.text_encoder_2)) if m is not None}

    def scaled_tower_weights(self, comp: str,
                             lora_scale: float) -> Optional[Dict[str, torch.Tensor]]:
        """The weights of text tower `comp` ("text_encoder" or
        "text_encoder_2") with the active adapters fused from the pristine
        copies at their scales times `lora_scale`, for one
        ``torch.func.functional_call`` (``unified.py:449-480``: the
        per-request text-encoder LoRA scale); None when no adapter touches
        the tower."""
        module = self._lora_modules().get(comp)
        scaled = {n: w * lora_scale for n, w in self.adapters.items()}
        comp_adapters = {n: self._adapter_store[n][comp] for n in scaled
                         if comp in self._adapter_store[n]}
        if module is None or not comp_adapters:
            return None
        pristine = self._pristine.get(comp, {})
        return {**pristine, **fuse(module, comp_adapters, scaled, base=pristine)}

    def install_unet(self, weights: Dict[str, torch.Tensor]) -> None:
        """Make `weights` ({parameter name: tensor}, every UNet parameter)
        the UNet's own, in their dtype, and the base that adapters fuse
        from: full fine-tuning installs its fp32 masters (or their EMA), as
        the JAX trainer installs its tree; a quantized UNet is quantized
        again from them."""
        self._check_not_frozen("install_unet")
        with self._fp_tower():
            params = dict(self.unet.named_parameters())
            if sorted(weights) != sorted(params):
                raise ValueError("install_unet needs every UNet parameter, and only those")
            for n, t in weights.items():
                params[n].data = t.detach()
        self._pristine.pop("unet", None)


def _set_table(table: nn.Embedding, weight: torch.Tensor) -> None:
    """Give an embedding table new rows: a new frozen parameter."""
    table.weight = nn.Parameter(weight, requires_grad=False)
    table.num_embeddings = weight.shape[0]
