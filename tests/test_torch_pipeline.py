"""PyTorch/CUDA port: DDIM, tokenizer, images and the txt2img pipeline
against the JAX package, in fp32 on the CPU.

The end-to-end test runs the tiny SD1.5 model through both pipelines with
the same JAX-initialised weights (carried across by io/from_jax.py), the same
char-level vocab and the same injected latents: 4 DDIM steps, CFG 7.5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_tokenizer
from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.models import clip as jclip
from stablediffusion_tpu.models import unet as junet
from stablediffusion_tpu.models import vae as jvae
from stablediffusion_tpu.models.wrapper import SDModel as JSDModel
from stablediffusion_tpu.pipelines.unified import (
    StableDiffusionUnifiedPipeline as JPipeline,
)
from stablediffusion_tpu.schedulers import make_scheduler as jmake_scheduler
from stablediffusion_tpu.tokenizer.clip_bpe import CLIPTokenizer as JTokenizer
from stablediffusion_tpu.utils import images as jimages
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.io.from_jax import load_from_jax
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import UNPORTED_PREFIXES, AutoencoderKL
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.schedulers import make_scheduler
from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer
from stablediffusion_tpu_torch.utils import images as timages


# -- DDIM ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "overrides, steps",
    [
        ({}, 20),
        ({"timestep_spacing": "trailing"}, 7),
        ({"timestep_spacing": "linspace", "set_alpha_to_one": True}, 10),
        ({"beta_schedule": "linear", "prediction_type": "v_prediction"}, 4),
        ({"prediction_type": "sample", "clip_sample": True}, 5),
    ],
)
def test_ddim_plan_and_step_match_jax(overrides, steps):
    jc = dataclasses.replace(jcfg.SchedulerConfig(), **overrides)
    tc = dataclasses.replace(tcfg.SchedulerConfig(), **overrides)
    js, ts = jmake_scheduler("DDIM", jc), make_scheduler("DDIM", tc)
    jp, tp = js.plan(steps), ts.plan(steps)
    np.testing.assert_array_equal(tp.timesteps, np.asarray(jp.timesteps))
    np.testing.assert_array_equal(tp.alphas_cumprod, np.asarray(jp.alphas_cumprod))
    assert tp.final_alpha_cumprod == float(jp.final_alpha_cumprod)
    assert (tp.num_steps, tp.step_ratio, tp.init_noise_sigma) == (
        jp.num_steps, jp.step_ratio, float(jp.init_noise_sigma))
    rng = np.random.default_rng(0)
    for i in (0, steps // 2, steps - 1):  # the last step uses final_alpha_cumprod
        x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        eps = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        ref, _ = js.step(jp, (), i, jnp.asarray(eps), jnp.asarray(x))
        out = ts.step(tp, i, torch.from_numpy(eps), torch.from_numpy(x))
        # same fp32 scalars and fp32 elementwise ops: ulp-level differences
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_ddim_step_keeps_sample_dtype():
    s = make_scheduler("DDIM")
    plan = s.plan(20)
    x = torch.randn(1, 4, 8, 8, dtype=torch.bfloat16)
    assert s.step(plan, 3, x.float(), x).dtype == torch.bfloat16


def test_other_schedulers_name_their_slice():
    with pytest.raises(NotImplementedError, match="slice 2"):
        make_scheduler("euler_a")
    with pytest.raises(ValueError):
        make_scheduler("no-such-scheduler")


# -- tokenizer and images -----------------------------------------------------


@pytest.mark.parametrize(
    "text",
    ["a cat", "A  DOG, sitting!", "cat's dog-house 42", "cafÃ© &amp; cat",
     "", "x" * 200],
)
def test_tokenizer_matches_jax(text):
    jt = tiny_tokenizer()
    merges = [m for m, _ in sorted(jt.bpe_ranks.items(), key=lambda kv: kv[1])]
    tt = CLIPTokenizer(dict(jt.vocab), merges)
    np.testing.assert_array_equal(tt([text, "a dog"]), jt([text, "a dog"]))


def test_tokenizer_from_files_matches_jax(tmp_path):
    jt = tiny_tokenizer(pad_token_id=0)
    jt.save_pretrained(str(tmp_path))
    tt = CLIPTokenizer.from_pretrained(str(tmp_path))
    jt2 = JTokenizer.from_pretrained(str(tmp_path))
    assert tt.pad_token_id == jt2.pad_token_id
    assert (tt.bos_token_id, tt.eos_token_id) == (jt2.bos_token_id, jt2.eos_token_id)
    np.testing.assert_array_equal(tt("a dog and a cat"), jt2("a dog and a cat"))


def test_images_match_jax():
    x = (np.random.default_rng(0).standard_normal((1, 4, 4, 3)) * 1.5).astype(np.float32)
    np.testing.assert_array_equal(timages.postprocess_image(x), jimages.postprocess_image(x))
    np.testing.assert_array_equal(timages.to_uint8(x), jimages.to_uint8(x))


# -- end to end ---------------------------------------------------------------


def _init(module, cfg, key):
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(module.init_params, static_argnums=1)(key, cfg)
    )


@pytest.fixture(scope="module")
def models():
    keys = jax.random.split(jax.random.key(0), 3)
    ju, jv, jt = jcfg.tiny_unet_config(), jcfg.tiny_vae_config(), jcfg.tiny_clip_config()
    up, vp, tp = _init(junet, ju, keys[0]), _init(jvae, jv, keys[1]), _init(jclip, jt, keys[2])
    jtok = tiny_tokenizer()
    jmodel = JSDModel(
        model_type="sd15", unet_config=ju, unet_params=up, vae_config=jv,
        vae_params=vp, text_encoder_config=jt, text_encoder_params=tp,
        tokenizer=jtok,
    )
    uc, vc, tc = tcfg.tiny_unet_config(), tcfg.tiny_vae_config(), tcfg.tiny_clip_config()
    merges = [m for m, _ in sorted(jtok.bpe_ranks.items(), key=lambda kv: kv[1])]
    tmodel = SDModel(
        unet_config=uc, unet=load_from_jax(UNet2DConditionModel(uc), up),
        vae_config=vc,
        vae=load_from_jax(AutoencoderKL(vc), vp, skip_prefixes=UNPORTED_PREFIXES),
        text_encoder_config=tc, text_encoder=load_from_jax(CLIPTextModel(tc), tp),
        tokenizer=CLIPTokenizer(dict(jtok.vocab), merges),
    )
    return jmodel, tmodel


@pytest.mark.parametrize(
    "prompt, negative, n",
    [("a cat", None, 1), (["a cat", "a dog"], "bad", 2)],
)
def test_txt2img_matches_jax(models, prompt, negative, n):
    jmodel, tmodel = models
    B = (1 if isinstance(prompt, str) else len(prompt)) * n
    lat = np.random.default_rng(5).standard_normal((B, 16, 16, 4)).astype(np.float32)
    common = dict(prompt=prompt, negative_prompt=negative, num_images_per_prompt=n,
                  num_inference_steps=4, guidance_scale=7.5)
    jpipe = JPipeline(do_cfg=True)
    tpipe = StableDiffusionUnifiedPipeline(device="cpu")
    assert tpipe.dtype == torch.float32
    jl = jpipe(jmodel, latents=jnp.asarray(lat), output_type="latents", seed=0, **common).latents
    tl = tpipe(tmodel, latents=torch.from_numpy(lat), output_type="latents", seed=0, **common).latents
    assert tuple(tl.shape) == (B, 16, 16, 4)
    # fp32 on both sides through 4 UNet evaluations (CFG x7.5 amplifies the
    # differences in summation order of the guidance difference)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    ji = jpipe(jmodel, latents=jnp.asarray(lat), output_type="np", seed=0, **common).images
    out = tpipe(tmodel, latents=torch.from_numpy(lat), output_type="np", seed=0, **common)
    assert out.images.shape == (B, 32, 32, 3) and out.images.dtype == np.float32
    np.testing.assert_allclose(out.images, ji, atol=1e-4)
    u8 = tpipe(tmodel, latents=torch.from_numpy(lat), output_type="uint8", **common).images
    assert u8.dtype == np.uint8 and u8.shape == (B, 32, 32, 3)


def test_vae_decode_latents_mean_std_matches_jax(models):
    """The latents_mean/latents_std branch of _vae_decode (unified.py:180-183)."""
    from stablediffusion_tpu.pipelines.unified import _vae_decode as jdecode

    jmodel, tmodel = models
    cfg = dataclasses.replace(
        tmodel.vae_config, latents_mean=(0.1, -0.2, 0.3, 0.05),
        latents_std=(0.9, 1.1, 0.8, 1.2), scaling_factor=0.5,
    )
    jc = dataclasses.replace(jmodel.vae_config, latents_mean=cfg.latents_mean,
                             latents_std=cfg.latents_std, scaling_factor=0.5)
    lat = np.random.default_rng(6).standard_normal((1, 16, 16, 4)).astype(np.float32)
    ref = jdecode(jmodel.vae_params, jnp.asarray(lat), config=jc, force_upcast=True)
    pipe = StableDiffusionUnifiedPipeline(device="cpu")
    with torch.no_grad():
        out = pipe._vae_decode(dataclasses.replace(tmodel, vae_config=cfg),
                               torch.from_numpy(lat).permute(0, 3, 1, 2))
    # fp32 on both sides through the tiny decoder, as test_vae_decode_matches_jax
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("vae_dtype, want", [(None, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_vae_decode_dtype_policy(models, vae_dtype, want):
    """force_upcast decodes bf16 latents in fp32; vae_dtype overrides it."""
    _, tmodel = models
    pipe = StableDiffusionUnifiedPipeline(device="cpu", dtype=torch.bfloat16, vae_dtype=vae_dtype)
    assert tmodel.vae_config.force_upcast
    lat = torch.randn(1, 4, 16, 16, dtype=torch.bfloat16)
    with torch.no_grad():
        assert pipe._vae_decode(tmodel, lat).dtype == want


def test_txt2img_seeded_latents_are_reproducible(models):
    _, tmodel = models
    pipe = StableDiffusionUnifiedPipeline(device="cpu")
    kw = dict(prompt="a cat", num_inference_steps=2, guidance_scale=7.5, output_type="latents")
    a, b, c = (pipe(tmodel, seed=s, **kw).latents for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert pipe(tmodel, seed=3, **kw).seed == 3
