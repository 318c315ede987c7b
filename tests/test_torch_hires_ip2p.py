"""PyTorch/CUDA port: the hires fix and InstructPix2Pix against the JAX
package, in fp32 on the CPU, and the misuse guards of JAX's
tests/test_{pag,ip2p,hires_fix,freeu}.py.

The hires fix's two passes each take the JAX draws of the same pass
(``torch_port_helpers.capture_jax_draw_calls``): scales 2 and 1.5, an
explicit ``hires_steps`` over a custom sigma schedule, decoded images with
PAG and a seed list.  InstructPix2Pix on an 8-channel UNet from pixels and
from latents, with and without text CFG.  Latents and pixels within TOL of
max(1, max |ref|); each guard raises the JAX package's ValueError.
"""

import numpy as np
import pytest
import torch

from stablediffusion_tpu.pipelines.unified import StableDiffusionUnifiedPipeline as JPipeline
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from torch_port_helpers import (  # noqa: F401
    capture_jax_draw_calls,
    capture_jax_draws,
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

TOL = 1e-4
REQ = dict(prompt="a cat", negative_prompt="a dog", num_inference_steps=4,
           guidance_scale=7.5, seed=3, height=32, width=32, output_type="latents")


def _close(got, ref, tol=TOL):
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def sd15():
    tm = tiny_port_model(seed=5)
    return to_jax_model(tm), tm


@pytest.fixture(scope="module")
def sdxl():
    tm = tiny_sdxl_port_model(seed=6)
    return to_jax_model(tm), tm


def _pipes(jm, tm, kw, scheduler="euler"):
    jm.set_scheduler(scheduler)
    tm.set_scheduler(scheduler)
    with capture_jax_draws() as draws:
        ref = JPipeline()(jm, **kw)
    got = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **kw)
    return got, ref


@pytest.mark.parametrize("kw", [
    dict(hires_scale=2.0, height=64, width=64),
    dict(hires_scale=1.5, height=48, width=48, hires_strength=0.5, hires_steps=3),
    dict(hires_scale=2.0, height=64, width=64, sigmas=[14.0, 6.0, 2.0, 0.5], hires_steps=2),
    dict(hires_scale=2.0, height=48, width=48, output_type="np", pag_scale=1.5, seed=[4, 5],
         prompt=["a cat", "a dog"], negative_prompt=None),
], ids=["x2", "x1.5_steps", "x2_sigmas_steps", "x2_np_pag_seedlist"])
def test_hires_fix_matches_jax(sd15, kw):
    jm, tm = sd15
    kw = dict(REQ, **kw)
    jm.set_scheduler("euler")
    tm.set_scheduler("euler")
    with capture_jax_draw_calls() as calls:
        ref = JPipeline()(jm, **kw)
    assert len(calls) == 2
    got = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=calls, **kw)
    if kw["output_type"] == "latents":
        assert got.latents.shape[1:3] == (kw["height"] // 2, kw["width"] // 2)
        _close(got.latents, ref.latents)
    else:
        _close(got.images, ref.images)


@pytest.fixture(scope="module")
def ip2p():
    tm = tiny_port_model(in_channels=8, seed=7)
    return to_jax_model(tm), tm


@pytest.mark.parametrize("kw", [
    dict(image_guidance_scale=1.5),
    dict(image_guidance_scale=1.2, guidance_scale=1.0, output_type="np"),
    dict(image_guidance_scale=2.0, image="latents", scheduler="DDIM"),
], ids=["pixels", "no_text_cfg_np", "latent_image_ddim"])
def test_ip2p_matches_jax(ip2p, kw):
    jm, tm = ip2p
    img = np.random.default_rng(8).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    if kw.get("image") == "latents":
        img = np.random.default_rng(9).standard_normal((1, 16, 16, 4)).astype(np.float32)
    kw = dict(REQ, **{**kw, "image": img})
    got, ref = _pipes(jm, tm, kw, kw.pop("scheduler", "euler"))
    if kw["output_type"] == "latents":
        _close(got.latents, ref.latents)
    else:
        _close(got.images, ref.images)


IMG = np.zeros((32, 32, 3), np.float32)


@pytest.mark.parametrize("which, kw, match", [
    ("sd15", dict(pag_scale=2.0, pag_applied_layers=("side",)), "pag_applied_layers"),
    ("sd15", dict(pag_scale=2.0, pag_applied_layers=()), "pag_applied_layers"),
    ("sd15", dict(pag_scale=2.0, cache_interval=3), "cannot combine"),
    ("sd15", dict(hires_scale=2.0, image=IMG), "txt2img only"),
    ("sd15", dict(hires_scale=2.0, use_refiner=True), "txt2img only"),
    ("sd15", dict(hires_scale=2.0, latents=np.zeros((1, 16, 16, 4), np.float32)),
     "pinned latents"),
    ("sd15", dict(hires_scale=2.0, denoising_end=0.5), "cannot combine"),
    ("sd15", dict(freeu=(1.0, 2.0)), "freeu must be"),
    ("sd15", dict(image_guidance_scale=1.5), "needs `image`"),
    ("sd15", dict(image_guidance_scale=1.5, image=IMG), "8-channel"),
    ("ip2p", dict(image_guidance_scale=1.5, image=IMG, mask_image=IMG[..., 0]),
     "needs `image`"),
    ("ip2p", dict(image_guidance_scale=1.5, image=IMG, pag_scale=1.0), "cannot combine"),
    ("ip2p", dict(image_guidance_scale=1.5, image=IMG, control_image=IMG), "cannot combine"),
    ("ip2p", dict(), "8 input channels"),
    ("sdxl", dict(image_guidance_scale=1.5, image=IMG), "8-channel"),
])
def test_misuse_guards_raise_as_jax(sd15, sdxl, ip2p, which, kw, match):
    jm, tm = {"sd15": sd15, "sdxl": sdxl, "ip2p": ip2p}[which]
    kw = dict(REQ, **kw)
    with pytest.raises(ValueError, match=match):
        JPipeline()(jm, **kw)
    with pytest.raises(ValueError, match=match):
        StableDiffusionUnifiedPipeline(device="cpu")(tm, **kw)
