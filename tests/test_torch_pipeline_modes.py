"""PyTorch/CUDA port: the pipeline's img2img, inpaint and schedule modes
against the JAX pipeline, in fp32 on the CPU.

Both pipelines run the same tiny models (random torch weights, carried to
the JAX package by its io/torch_convert.py).  The JAX pipeline draws from ``jax.random`` and the port
from ``torch.Generator``s, so each case recomputes the JAX draws (latents,
VAE-encode noise, per-step noise; per sample and site for a seed list, as
``unified.py:969-990`` folds them) and injects them into the port through
``draws=`` (the newer cases capture them from the JAX call instead, through
``torch_port_helpers.capture_jax_draws``).  Latents and pixels must agree
within 1e-4 of
max(1, max |ref|): pixels lie in [0, 1], while latents under the Euler
family carry x0 + sigma * eps with sigma up to 14.6, where fp32 rounding
alone reaches 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.models import vae as jvae
from stablediffusion_tpu.pipelines.unified import (
    StableDiffusionUnifiedPipeline as JPipeline,
)
from stablediffusion_tpu_torch.models.vae import tiled_decode, tiled_encode
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    port_test_module,
    tiny_port_model,
    to_jax_model,
)

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    t4, t9 = tiny_port_model(4, seed=0), tiny_port_model(9, seed=1)
    return {4: (to_jax_model(t4), t4), 9: (to_jax_model(t9), t9)}


def jax_draws(seed, batch, hw, n_steps, encode_batch=None):
    """The draws of the JAX pipeline's __call__ for `seed` (an int or a
    per-sample list), NHWC: latents [batch, h, w, 4], VAE-encode noise for
    the image and the masked image [encode_batch, h, w, 4], and step noise
    [n_steps, batch, h, w, 4]."""
    shape = (batch, *hw, 4)
    normal = lambda k, s: np.array(jax.random.normal(k, s, jnp.float32))  # noqa: E731
    d = {}
    if isinstance(seed, list):
        keys = jax.vmap(jax.random.key)(jnp.asarray(seed, jnp.uint32))
        psk = lambda tag: jax.vmap(lambda kk: jax.random.fold_in(kk, tag))(keys)  # noqa: E731
        per = lambda ks, s: np.array(jax.vmap(  # noqa: E731
            lambda k: jax.random.normal(k, s, jnp.float32))(ks))
        d["latents"] = per(psk(0), shape[1:])
        steps = jnp.moveaxis(jax.vmap(lambda kk: jax.random.split(kk, n_steps))(psk(2)), 0, 1)
        d["steps"] = np.stack([per(steps[i], shape[1:]) for i in range(n_steps)])
        return d
    k_latent, k_encode, k_steps, k_mask = jax.random.split(jax.random.key(seed), 4)
    d["latents"] = normal(k_latent, shape)
    if encode_batch:
        d["encode"] = normal(k_encode, (encode_batch, *hw, 4))
        d["encode_masked"] = normal(k_mask, (encode_batch, *hw, 4))
    d["steps"] = np.stack([normal(k, shape) for k in jax.random.split(k_steps, n_steps)])
    return d


def _image(seed, hw=32):
    return np.random.default_rng(seed).uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)


def _mask(hw=32):
    m = np.zeros((hw, hw), np.float32)
    m[hw // 4: 3 * hw // 4, hw // 4: 3 * hw // 4] = 1.0
    return m


# (name, UNet channels, scheduler, request, JAX plan length or None for the
# default, whether a VAE encode is drawn)
CASES = {
    "img2img_euler_a": (4, "euler_a", dict(image=_image(1), strength=0.6), 6, True),
    "blend4": (4, "DDIM", dict(image=_image(2), mask_image=_mask(), strength=0.8), 8, True),
    "concat9": (9, "DPM++ 2M SDE Karras", dict(image=_image(3), mask_image=_mask()), 10, True),
    "rescale_sigmas_clip_skip": (4, "DPM++ 2M", dict(
        guidance_rescale=0.7, clip_skip=1, sigmas=[12.0, 5.0, 2.0, 0.8, 0.3, 0.05]), 6, False),
    "img2img_denoising_start": (4, "DDIM", dict(image=_image(5), denoising_start=0.6), 4, True),
    "timesteps_end_seeds": (4, "euler_a", dict(timesteps=[980, 800, 600, 420, 250, 90],
                                               denoising_end=0.5, seed=[11, 12],
                                               prompt=["a cat", "a dog"]), 3, False),
    "padding_crop": (4, "DDIM", dict(image=_image(4), mask_image=_mask(),
                                     padding_mask_crop=2, strength=0.7), 7, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_jax(models, case):
    ch, sched, req, n_steps, encodes = CASES[case]
    jm, tm = models[ch]
    jm.set_scheduler(sched)
    tm.set_scheduler(sched)
    req = dict(req)
    seed = req.pop("seed", 5)
    prompt = req.pop("prompt", "a cat")
    B = len(prompt) if isinstance(prompt, list) else 1
    draws = jax_draws(seed, B, (16, 16), n_steps, encode_batch=1 if encodes else None)
    common = dict(prompt=prompt, negative_prompt=None, num_inference_steps=10,
                  guidance_scale=7.5, **req)
    out_type = "np" if "mask_image" in req else "latents"
    jout = JPipeline(do_cfg=True)(jm, seed=seed, output_type=out_type, **common)
    tout = StableDiffusionUnifiedPipeline(device="cpu")(
        tm, seed=seed, output_type=out_type, draws=draws, **common)
    assert tout.seed == jout.seed
    if out_type == "latents":
        out, ref = tout.latents.numpy(), np.asarray(jout.latents)
    else:
        out, ref = tout.images, np.asarray(jout.images)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=TOL * max(1.0, float(np.abs(ref).max())))


# cases whose draws are captured from the JAX call itself (its randn, its VAE
# encodes' keys and the step keys handed to _denoise) rather than recomputed
CAPTURED_CASES = {
    "img2img_heun": (4, "heun", dict(image=_image(6), strength=0.6)),
    "img2img_pndm": (4, "PNDM", dict(image=_image(7), strength=0.7)),
    "blend4_heun": (4, "heun", dict(image=_image(8), mask_image=_mask(), strength=0.8)),
    "concat9_seed_list": (9, "euler_a", dict(image=_image(9), mask_image=_mask(),
                                             prompt=["a cat", "a dog"], seed=[21, 22])),
}


@pytest.mark.parametrize("case", list(CAPTURED_CASES))
def test_mode_with_captured_draws_matches_jax(models, case):
    ch, sched, req = CAPTURED_CASES[case]
    jm, tm = models[ch]
    jm.set_scheduler(sched)
    tm.set_scheduler(sched)
    req = dict(req)
    req.setdefault("seed", 5)
    req.setdefault("prompt", "a cat")
    common = dict(num_inference_steps=10, guidance_scale=7.5, **req)
    out_type = "np" if "mask_image" in req else "latents"
    with capture_jax_draws() as draws:
        jout = JPipeline(do_cfg=True)(jm, output_type=out_type, **common)
    tout = StableDiffusionUnifiedPipeline(device="cpu")(
        tm, output_type=out_type, draws=draws, **common)
    assert tout.seed == jout.seed
    out, ref = ((tout.latents.numpy(), np.asarray(jout.latents)) if out_type == "latents"
                else (tout.images, np.asarray(jout.images)))
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=TOL * max(1.0, float(np.abs(ref).max())))


def test_tiled_vae_matches_jax(models):
    """Tiled decode (3x3 tiles of 8 latents) and encode (2x2 tiles of 16
    pixels) with blended seams, module level, against the JAX functions."""
    jm, tm = models[4]
    r = np.random.default_rng(9)
    lat = r.standard_normal((1, 20, 20, 4)).astype(np.float32)
    ref = jvae.tiled_decode(jm.vae_params, jm.vae_config, jnp.asarray(lat), tile_latent=8)
    with torch.no_grad():
        out = tiled_decode(tm.vae, torch.from_numpy(lat).permute(0, 3, 1, 2), tile_latent=8)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=TOL)
    pix = r.uniform(-1, 1, (1, 24, 24, 3)).astype(np.float32)
    jmean, jlogvar = jvae.tiled_encode(jm.vae_params, jm.vae_config, jnp.asarray(pix),
                                       tile_sample=16)
    with torch.no_grad():
        mean, logvar = tiled_encode(tm.vae, torch.from_numpy(pix).permute(0, 3, 1, 2),
                                    tile_sample=16)
    np.testing.assert_allclose(mean.permute(0, 2, 3, 1).numpy(), np.asarray(jmean), atol=TOL)
    np.testing.assert_allclose(logvar.permute(0, 2, 3, 1).numpy(), np.asarray(jlogvar),
                               atol=TOL)


def test_vae_tiling_in_the_pipeline_matches_jax(models):
    """txt2img at 136x136 (68x68 latents): the pipeline decodes in 2x2 tiles
    of 64 latents."""
    jm, tm = models[4]
    jm.set_scheduler("DDIM")
    tm.set_scheduler("DDIM")
    lat = np.random.default_rng(4).standard_normal((1, 68, 68, 4)).astype(np.float32)
    common = dict(prompt="a dog", num_inference_steps=1, guidance_scale=7.5, height=136,
                  width=136, vae_tiling=True, output_type="np")
    ref = JPipeline(do_cfg=True)(jm, latents=jnp.asarray(lat), seed=0, **common).images
    out = StableDiffusionUnifiedPipeline(device="cpu")(
        tm, latents=torch.from_numpy(lat), seed=0, **common).images
    np.testing.assert_allclose(out, np.asarray(ref), atol=TOL)


def test_seed_list_is_per_sample(models):
    """With a seed list each sample draws from its own generators, through
    stochastic steps: sample 1 of [7, 8] equals sample 1 of [9, 8] exactly,
    and sample 0 of [8] alone within 1e-4 (the CPU's fp32 GEMMs and
    convolutions block by batch size, so a batch of 1 rounds otherwise)."""
    _, tm = models[4]
    tm.set_scheduler("euler_a")
    pipe = StableDiffusionUnifiedPipeline(device="cpu")
    kw = dict(prompt=["a cat", "a dog"], num_inference_steps=3, guidance_scale=7.5,
              output_type="latents")
    pair = pipe(tm, seed=[7, 8], **kw)
    other = pipe(tm, seed=[9, 8], **kw)
    solo = pipe(tm, **dict(kw, prompt=["a dog"]), seed=[8])
    assert pair.seed == [7, 8]
    assert torch.equal(pair.latents[1], other.latents[1])
    assert not torch.equal(pair.latents[0], other.latents[0])
    torch.testing.assert_close(pair.latents[1:], solo.latents, rtol=0, atol=TOL)


def test_prompt_embeds_equal_the_prompt(models):
    """Precomputed embeddings give the latents of the prompt they encode."""
    _, tm = models[4]
    tm.set_scheduler("DDIM")
    pipe = StableDiffusionUnifiedPipeline(device="cpu")
    emb, neg, _, _ = pipe.encode_prompt(tm, "a cat", negative_prompt="a dog")
    kw = dict(num_inference_steps=2, guidance_scale=7.5, seed=3, output_type="latents")
    a = pipe(tm, prompt="a cat", negative_prompt="a dog", **kw).latents
    b = pipe(tm, prompt_embeds=emb, negative_prompt_embeds=neg, **kw).latents
    assert torch.equal(a, b)


def test_uint8_device_and_unported_arguments(models):
    _, tm = models[4]
    tm.set_scheduler("DDIM")
    pipe = StableDiffusionUnifiedPipeline(device="cpu")
    kw = dict(prompt="a cat", num_inference_steps=2, guidance_scale=7.5, seed=1)
    dev = pipe(tm, output_type="uint8_device", **kw).images
    host = pipe(tm, output_type="uint8", **kw).images
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), host)
    # the extensions are ported (their parity cases are in
    # test_torch_extensions.py and test_torch_hires_ip2p.py): each runs and
    # changes the image
    for extra in (dict(hires_scale=2.0), dict(freeu=True), dict(pag_scale=3.0)):
        im = pipe(tm, output_type="uint8", **kw, **extra).images
        assert im.shape == host.shape and not np.array_equal(im, host)
    # SD3's arguments belong to the SD3 pipeline; here, as in the JAX
    # pipeline, they are unexpected keywords
    with pytest.raises(TypeError, match="prompt_3"):
        pipe(tm, prompt_3="x", **kw)
    # the SDXL arguments are ported: on an SD1.5 model prompt_2 is ignored
    # and use_refiner needs a loaded refiner, as in the JAX pipeline
    np.testing.assert_array_equal(pipe(tm, output_type="uint8", prompt_2="x", **kw).images,
                                  host)
    with pytest.raises(ValueError, match="no refiner loaded"):
        pipe(tm, use_refiner=True, **kw)
    # off-valued extension settings are accepted, as the JAX pipeline takes them
    pipe(tm, pag_scale=0.0, hires_strength=0.5, cache_interval=1, **kw)
    with pytest.raises(TypeError):
        pipe(tm, no_such_argument=1, **kw)
