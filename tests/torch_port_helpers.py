"""Tiny models for the port's CPU tests, built without JAX's slow
initialisation: random torch weights in the port's modules, carried to the
JAX package's param trees through its own ``io/torch_convert.py`` (the port
stores the torch layouts that diffusers files hold)."""

import contextlib
import dataclasses
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import tiny_tokenizer
from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.io.torch_convert import convert_state_dict
from stablediffusion_tpu.models.wrapper import SDModel as JSDModel
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer


def _init(module: torch.nn.Module, g: torch.Generator) -> torch.nn.Module:
    """The JAX package's scales (``models/unet.py:312``: linears at std
    fan_in^-0.5, convolutions at 0.3 of it), with norm scales 1 + N(0, 0.02)
    and biases N(0, 0.02) in place of its constants."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.normal_(0.0, 0.02, generator=g)
                if name.endswith("weight"):
                    p.add_(1.0)
            else:
                fan_in = p.shape[0] if name.endswith("embedding.weight") else p[0].numel()
                p.normal_(0.0, (0.3 if p.dim() == 4 else 1.0) * fan_in**-0.5, generator=g)
    return module.eval().requires_grad_(False)


def port_tokenizer(pad_token_id=None) -> CLIPTokenizer:
    tok = tiny_tokenizer()
    merges = [m for m, _ in sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1])]
    return CLIPTokenizer(dict(tok.vocab), merges, pad_token_id=pad_token_id)


def tiny_port_model(in_channels: int = 4, seed: int = 0) -> SDModel:
    """A tiny SD1.5-layout port model on the CPU, fp32."""
    g = torch.Generator().manual_seed(seed)
    uc = tcfg.tiny_unet_config(in_channels=in_channels)
    vc, cc = tcfg.tiny_vae_config(), tcfg.tiny_clip_config()
    return SDModel(
        unet_config=uc, unet=_init(UNet2DConditionModel(uc), g),
        vae_config=vc, vae=_init(AutoencoderKL(vc), g),
        text_encoder_config=cc, text_encoder=_init(CLIPTextModel(cc), g),
        tokenizer=port_tokenizer(),
    )


def tiny_sdxl_unet_config(cross_attention_dim: int = 64, n_time_ids: int = 6):
    """The port's tiny SDXL-layout UNet (linear projections, text_time over
    a projected pooled of 32 and `n_time_ids` ids at 8), with two
    transformer layers and 2 heads at the first level, one layer and 4 heads
    at the second and in the mid-block."""
    return dataclasses.replace(
        tcfg.tiny_unet_config(cross_attention_dim=cross_attention_dim, sdxl=True),
        transformer_layers_per_block=(2, 1), num_attention_heads=(2, 4),
        projection_class_embeddings_input_dim=32 + n_time_ids * 8)


def tiny_sdxl_port_model(seed: int = 0, refiner: bool = False) -> SDModel:
    """A tiny SDXL-layout port model on the CPU, fp32: CLIP-L-like and
    bigG-like towers (the second with gelu and a projection; its tokenizer
    pads with id 0), hidden states 32 + 32 wide; with `refiner`, a refiner UNet
    conditioned on the second tower and five time ids."""
    g = torch.Generator().manual_seed(seed)
    uc = tiny_sdxl_unet_config()
    vc, cc = tcfg.tiny_vae_config(), tcfg.tiny_clip_config()
    c2 = dataclasses.replace(tcfg.tiny_clip_config(with_projection=True), hidden_act="gelu")
    model = SDModel(
        unet_config=uc, unet=_init(UNet2DConditionModel(uc), g),
        vae_config=vc, vae=_init(AutoencoderKL(vc), g),
        text_encoder_config=cc, text_encoder=_init(CLIPTextModel(cc), g),
        tokenizer=port_tokenizer(), model_type="sdxl",
        text_encoder_2_config=c2, text_encoder_2=_init(CLIPTextModel(c2), g),
        tokenizer_2=port_tokenizer(pad_token_id=0),
    )
    if refiner:
        rc = tiny_sdxl_unet_config(cross_attention_dim=32, n_time_ids=5)
        model.refiner_config, model.refiner = rc, _init(UNet2DConditionModel(rc), g)
    return model


def tiny_sd3_port_model(seed: int = 0, with_t5: bool = True, dual=(), qk_norm=None):
    """A tiny SD3-family port model on the CPU, fp32, in the layout of the
    JAX tests' ``make_tiny_sd3_model``: the tiny MM-DiT (`dual` MMDiT-X
    blocks, `qk_norm`), CLIP-L-like and bigG-like towers with projections of
    12 and 8 (pooled 20, hidden 32 + 32 zero-padded to the joint width 80),
    a T5 of d_model 80 with ``bench_t5_tokenizer(extra_ids=4)``, and an
    SD3-style VAE without quant convs whose latents carry a shift."""
    from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel
    from stablediffusion_tpu_torch.models.t5 import T5EncoderModel, tiny_t5_config
    from stablediffusion_tpu_torch.pipelines.sd3 import SD3Model
    from stablediffusion_tpu_torch.utils.testing import bench_t5_tokenizer

    g = torch.Generator().manual_seed(seed)
    tf = dataclasses.replace(tcfg.tiny_sd3_config(), dual_attention_layers=tuple(dual),
                             qk_norm=qk_norm)
    vc = dataclasses.replace(tcfg.tiny_vae_config(), use_quant_conv=False,
                             use_post_quant_conv=False, shift_factor=0.1, scaling_factor=1.5)
    c1 = dataclasses.replace(tcfg.tiny_clip_config(with_projection=True), projection_dim=12)
    c2 = dataclasses.replace(tcfg.tiny_clip_config(with_projection=True), projection_dim=8,
                             hidden_act="gelu")
    t5 = {}
    if with_t5:
        t5c = dataclasses.replace(tiny_t5_config(), d_model=tf.joint_attention_dim)
        t5 = dict(text_encoder_3_config=t5c, text_encoder_3=_init(T5EncoderModel(t5c), g),
                  tokenizer_3=bench_t5_tokenizer(extra_ids=4))
    return SD3Model(
        transformer_config=tf, transformer=_init(SD3Transformer2DModel(tf), g),
        vae_config=vc, vae=_init(AutoencoderKL(vc), g),
        text_encoder_config=c1, text_encoder=_init(CLIPTextModel(c1), g),
        tokenizer=port_tokenizer(),
        text_encoder_2_config=c2, text_encoder_2=_init(CLIPTextModel(c2), g),
        tokenizer_2=port_tokenizer(pad_token_id=0),
        scheduler_config=tcfg.SchedulerConfig(shift=3.0), **t5)


def to_jax_sd3_model(model):
    """The same weights and configs as a JAX SD3Model (T5 with the JAX
    package's own ``bench_t5_tokenizer`` of the same vocabulary)."""
    from stablediffusion_tpu.models.t5 import T5Config as JT5Config
    from stablediffusion_tpu.pipelines.sd3 import SD3Model as JSD3Model
    from stablediffusion_tpu.utils.testing import bench_t5_tokenizer

    extra = {}
    if model.text_encoder_3 is not None:
        extra = dict(text_encoder_3_config=_jax_cfg(JT5Config, model.text_encoder_3_config),
                     text_encoder_3_params=jax_tree(model.text_encoder_3),
                     tokenizer_3=bench_t5_tokenizer(extra_ids=4))
    return JSD3Model(
        transformer_config=_jax_cfg(jcfg.SD3Config, model.transformer_config),
        transformer_params=jax_tree(model.transformer),
        vae_config=_jax_cfg(jcfg.VAEConfig, model.vae_config), vae_params=jax_tree(model.vae),
        text_encoder_config=_jax_cfg(jcfg.CLIPTextConfig, model.text_encoder_config),
        text_encoder_params=jax_tree(model.text_encoder), tokenizer=tiny_tokenizer(),
        text_encoder_2_config=_jax_cfg(jcfg.CLIPTextConfig, model.text_encoder_2_config),
        text_encoder_2_params=jax_tree(model.text_encoder_2),
        tokenizer_2=tiny_tokenizer(pad_token_id=0),
        scheduler_config=_jax_cfg(jcfg.SchedulerConfig, model.scheduler_config), **extra)


@contextlib.contextmanager
def capture_jax_sd3_draws():
    """As :func:`capture_jax_draws`, for the JAX SD3 pipeline: "latents"
    (its one ``randn``) and "encode" (the VAE encode's sampling noise, from
    the key handed to ``_sd3_vae_encode_any``)."""
    from stablediffusion_tpu.pipelines import sd3 as js

    draws = {}
    orig = {n: getattr(js, n) for n in ("randn", "_sd3_vae_encode_any")}

    def randn(*args, **kw):
        out = orig["randn"](*args, **kw)
        assert "latents" not in draws, "a second randn in one call"
        draws["latents"] = np.array(out, np.float32)
        return out

    def vae_encode_any(params, image, key, **kw):
        out = orig["_sd3_vae_encode_any"](params, image, key, **kw)
        if kw.get("sample", True):
            draws["encode"] = _jax_noise(key, out.shape)
        return out

    js.randn, js._sd3_vae_encode_any = randn, vae_encode_any
    try:
        yield draws
    finally:
        for n, f in orig.items():
            setattr(js, n, f)


def _jax_cfg(cls, cfg):
    """The JAX package's dataclass with the port config's fields (the two
    keep the same names and defaults)."""
    return cls(**dataclasses.asdict(cfg))


def jax_tree(module: torch.nn.Module) -> dict:
    """A port module's weights as the JAX package's param tree."""
    return convert_state_dict({k: np.asarray(v) for k, v in module.state_dict().items()})


def to_jax_model(model: SDModel) -> JSDModel:
    """The same weights and configs as a JAX SDModel (SDXL's second tower
    and a refiner too)."""
    tree = jax_tree
    extra = {}
    if model.is_sdxl:
        extra.update(
            text_encoder_2_config=_jax_cfg(jcfg.CLIPTextConfig, model.text_encoder_2_config),
            text_encoder_2_params=tree(model.text_encoder_2),
            tokenizer_2=tiny_tokenizer(pad_token_id=model.tokenizer_2.pad_token_id))
    if model.refiner is not None:
        extra.update(refiner_config=_jax_cfg(jcfg.UNetConfig, model.refiner_config),
                     refiner_params=tree(model.refiner))
    return JSDModel(
        model_type=model.model_type,
        unet_config=_jax_cfg(jcfg.UNetConfig, model.unet_config),
        unet_params=tree(model.unet), vae_config=_jax_cfg(jcfg.VAEConfig, model.vae_config),
        vae_params=tree(model.vae),
        text_encoder_config=_jax_cfg(jcfg.CLIPTextConfig, model.text_encoder_config),
        text_encoder_params=tree(model.text_encoder), tokenizer=tiny_tokenizer(),
        scheduler_config=_jax_cfg(jcfg.SchedulerConfig, model.scheduler_config),
        **extra,
    )


def _jax_noise(key, shape):
    """fp32 standard normal of `shape` from a key, or from a [B] vector of
    per-sample keys (each sample its own stream), as the JAX pipeline draws
    (``core/rng.randn``, ``schedulers/common.step_noise``)."""
    import jax
    import jax.numpy as jnp

    if key.ndim == 1:
        return np.array(jax.vmap(lambda k: jax.random.normal(k, shape[1:], jnp.float32))(key))
    return np.array(jax.random.normal(key, shape, jnp.float32))


@contextlib.contextmanager
def capture_jax_draw_calls():
    """The draws of each JAX pipeline pass made inside the block, as
    :func:`capture_jax_draws` records one call's (the hires fix runs two: its
    base pass, then its img2img pass): yields a list with one draws dict per
    pass, in order; a pass ends at its ``_denoise``."""
    from stablediffusion_tpu.pipelines import unified as ju

    calls, current = [], {}
    orig = {n: getattr(ju, n) for n in ("randn", "_vae_encode_any", "_denoise")}

    def randn(*args, **kw):
        out = orig["randn"](*args, **kw)
        assert "latents" not in current, "a second randn in one pass"
        current["latents"] = np.array(out, np.float32)
        return out

    def vae_encode_any(params, image, key, **kw):
        out = orig["_vae_encode_any"](params, image, key, **kw)
        if kw.get("sample", True):
            site = "encode_masked" if "encode" in current else "encode"
            current[site] = _jax_noise(key, out.shape)
        return out

    def denoise(unet_params, latents, embeds, plan, keys, *args, **kw):
        current["steps"] = np.stack([_jax_noise(keys[i], latents.shape)
                                     for i in range(keys.shape[0])])
        calls.append(dict(current))
        current.clear()
        return orig["_denoise"](unet_params, latents, embeds, plan, keys, *args, **kw)

    ju.randn, ju._vae_encode_any, ju._denoise = randn, vae_encode_any, denoise
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(ju, n, f)


@contextlib.contextmanager
def capture_jax_draws():
    """Record the random draws of the one JAX pipeline call made inside the
    block, as the port's ``draws=`` takes them (NHWC): "latents" (the one
    ``randn`` of a call: initial latents or the noise added to the image),
    "encode" and "encode_masked" (the VAE encodes' sampling noise, in call
    order) and "steps" [N, B, h, w, c] (from the keys handed to
    ``_denoise``).  Wraps the pipeline module's own functions, so the draws
    are the call's, not a recomputation of its key splits; the dict is
    filled when the block ends."""
    draws = {}
    with capture_jax_draw_calls() as calls:
        yield draws
    assert len(calls) <= 1, "a second pipeline pass in one call"
    draws.update(calls[0] if calls else {})


_JITTED = {}


def jitted(fn, static_argnums=(1,), static_argnames=()):
    """``jax.jit(fn)`` with the config (argument 1) and the named Python
    arguments static, made once per function: one compile of a tiny model
    takes a fraction of the first eager call's per-primitive compiles."""
    import jax

    key = (fn, tuple(static_argnums), tuple(static_argnames))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn, static_argnums=static_argnums,
                               static_argnames=static_argnames)
    return _JITTED[key]


# JAX's persistent compilation cache, shared by the port's test modules of
# one pytest run (all its xdist workers): the tiny models' denoise loops,
# train steps, draws and eager ops compile to the same programs in many of
# these files, and each worker would compile them again (a module's end
# drops the in-memory executables, tests/conftest.py).  A hit loads the same
# executable a compile would give.  Inside the checkout, one directory per
# run; a run removes the directories of earlier runs.  The references are
# also compiled with XLA's backend optimizations off
# (``jax_disable_most_optimizations``): on these tiny models compiling
# costs far more than running, and the programs compute the same functions,
# rounded apart by an ulp here and there.  A module that holds the JAX
# package bit for bit sets ``JAX_OPTIMIZED = True`` and keeps them on.
_JAX_CACHE_ROOT = Path(__file__).resolve().parent / ".jax_compile_cache"


@pytest.fixture(scope="module", autouse=True)
def port_test_module(request):
    """What each port test module runs under: one torch CPU thread (the tiny
    models' ops are too small to share out, and with several test workers on
    one machine each worker's full thread pool would contend for the same
    cores), and JAX compiles read from and written to this run's cache
    directory, made with few optimizations (the JAX package's own test
    modules run with neither)."""
    import jax
    from jax._src import compilation_cache, compiler

    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    path = _JAX_CACHE_ROOT / run
    if not path.exists():
        for old in _JAX_CACHE_ROOT.glob("*"):
            if old.name != run:
                shutil.rmtree(old, ignore_errors=True)
        path.mkdir(parents=True, exist_ok=True)
    options = {"jax_compilation_cache_dir": str(path),
               "jax_persistent_cache_min_compile_time_secs": 0.0}
    saved = {k: getattr(jax.config, k) for k in options}
    # a flag that jax.config updates but does not expose: read where the
    # compiler reads it
    saved["jax_disable_most_optimizations"] = compiler._DISABLE_MOST_OPTIMIZATIONS.value
    optimized = getattr(request.module, "JAX_OPTIMIZED", False)
    for k, v in dict(options, jax_disable_most_optimizations=not optimized).items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
