"""PyTorch/CUDA port: FreeU, PAG and DeepCache against the JAX package, in
fp32 on the CPU.

``fourier_filter`` and ``apply_freeu`` at odd and even sizes (the half-open
mask and ``fftshift`` on odd sizes) within 1e-5 (torch.fft against XLA's FFT
on the CPU); the UNet with ``pag_perturb``, ``freeu`` and DeepCache's
``return_deep_cache`` / ``deep_cache`` within TOL; ``F.interpolate`` against
``jax.image.resize`` (the hires fix's upscale); whole pipeline calls with
FreeU, PAG (with and without CFG) and DeepCache (a tail of full steps) on
the SD1.5 model (test_torch_extensions_sdxl.py runs them on SDXL's), the
JAX draws injected, within TOL of max(1, max |ref|).  The hires fix,
InstructPix2Pix and the misuse guards are in test_torch_hires_ip2p.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.models import unet as junet
from stablediffusion_tpu.ops import freeu as jfreeu
from stablediffusion_tpu.pipelines.unified import StableDiffusionUnifiedPipeline as JPipeline
from stablediffusion_tpu_torch.ops import freeu
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    jax_tree,
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


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 6), (1, 3)])
@pytest.mark.parametrize("threshold, scale", [(1, 0.2), (2, 0.9)])
def test_fourier_filter_matches_jax(hw, threshold, scale):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = jfreeu.fourier_filter(jnp.asarray(x), threshold, scale)
    got = freeu.fourier_filter(torch.from_numpy(x).permute(0, 3, 1, 2), threshold, scale)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_apply_freeu_matches_jax(idx):
    rng = np.random.default_rng(idx)
    back = rng.standard_normal((1, 5, 5, 6)).astype(np.float32)
    skip = rng.standard_normal((1, 5, 5, 4)).astype(np.float32)
    jb, js = jfreeu.apply_freeu(jnp.asarray(back), jnp.asarray(skip), idx, jfreeu.SD15_DEFAULTS)
    tb, ts = freeu.apply_freeu(torch.from_numpy(back).permute(0, 3, 1, 2),
                               torch.from_numpy(skip).permute(0, 3, 1, 2), idx,
                               freeu.SD15_DEFAULTS)
    np.testing.assert_allclose(tb.permute(0, 2, 3, 1).numpy(), np.asarray(jb), atol=1e-5)
    np.testing.assert_allclose(ts.permute(0, 2, 3, 1).numpy(), np.asarray(js), atol=1e-5)
    assert freeu.SDXL_DEFAULTS == jfreeu.SDXL_DEFAULTS


@pytest.fixture(scope="module")
def sd15():
    tm = tiny_port_model(seed=5)
    return to_jax_model(tm), tm


@pytest.fixture(scope="module")
def sdxl():
    tm = tiny_sdxl_port_model(seed=6)
    return to_jax_model(tm), tm


def _unet_inputs(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 16, 16, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((B, 7, cfg.cross_attention_dim)).astype(np.float32)
    added = None
    if cfg.addition_embed_type == "text_time":
        n_ids = 6
        pooled = cfg.projection_class_embeddings_input_dim - n_ids * cfg.addition_time_embed_dim
        added = {"text_embeds": rng.standard_normal((B, pooled)).astype(np.float32),
                 "time_ids": np.tile(np.float32([32, 32, 0, 0, 32, 32]), (B, 1))}
    return x, ctx, added


def _port(tm, x, ctx, added, **kw):
    """The port's UNet on NHWC numpy inputs (its output NCHW)."""
    tadded = None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}
    if "deep_cache" in kw:
        kw = dict(kw, deep_cache=torch.from_numpy(np.array(kw["deep_cache"])).permute(0, 3, 1, 2))
    with torch.no_grad():
        return tm.unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(500),
                       torch.from_numpy(ctx), tadded, **kw)


def _both(tm, x, ctx, added, **kw):
    """The port's and JAX's UNet on the same inputs: (port NHWC, JAX)."""
    cfg = tm.unet_config
    jadded = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    jkw = dict(kw)
    if "deep_cache" in kw:
        jkw["deep_cache"] = jnp.asarray(kw["deep_cache"])
    ref = junet.apply(jax_tree(tm.unet), dataclasses.replace(
        jcfg.UNetConfig(**dataclasses.asdict(cfg))), jnp.asarray(x), jnp.asarray(500),
        jnp.asarray(ctx), added_cond=jadded, **jkw)
    return _port(tm, x, ctx, added, **kw), ref


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
@pytest.mark.parametrize("kw", [
    dict(pag_perturb=("mid",)), dict(pag_perturb=("down", "up")),
    dict(pag_perturb=("down", "mid", "up"), freeu=(1.5, 1.6, 0.9, 0.2)),
    dict(freeu=(1.3, 1.4, 0.9, 0.2)),
], ids=["pag_mid", "pag_down_up", "pag_all_freeu", "freeu"])
def test_unet_pag_and_freeu_match_jax(sd15, sdxl, family, kw):
    _, tm = sd15 if family == "sd15" else sdxl
    x, ctx, added = _unet_inputs(tm.unet_config, seed=1)
    got, ref = _both(tm, x, ctx, added, **kw)
    _close(got.permute(0, 2, 3, 1), ref)
    assert not torch.allclose(got, _port(tm, x, ctx, added), atol=1e-3)


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_unet_deep_cache_matches_jax(sd15, sdxl, family):
    _, tm = sd15 if family == "sd15" else sdxl
    x, ctx, added = _unet_inputs(tm.unet_config, seed=2)
    (out, deep), (jout, jdeep) = _both(tm, x, ctx, added, return_deep_cache=True,
                                       freeu=(1.5, 1.6, 0.9, 0.2))
    _close(out.permute(0, 2, 3, 1), jout)
    _close(deep.permute(0, 2, 3, 1), jdeep)
    x2, _, _ = _unet_inputs(tm.unet_config, seed=3)
    got, ref = _both(tm, x2, ctx, added, deep_cache=np.asarray(jdeep),
                     freeu=(1.5, 1.6, 0.9, 0.2))  # FreeU stays off on a shallow step
    _close(got.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("factor", [2.0, 1.5, 1.25])
def test_bilinear_upscale_agrees_with_jax_resize(factor):
    lat = np.random.default_rng(4).standard_normal((2, 8, 12, 4)).astype(np.float32)
    h, w = int(8 * factor), int(12 * factor)
    ref = jax.image.resize(jnp.asarray(lat), (2, h, w, 4), "bilinear")
    got = F.interpolate(torch.from_numpy(lat).permute(0, 3, 1, 2), size=(h, w),
                        mode="bilinear", align_corners=False, antialias=False)
    # the same half-pixel-centre weights; the sums round differently in fp32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)


def _pipes(jm, tm, kw, scheduler="euler"):
    jm.set_scheduler(scheduler)
    tm.set_scheduler(scheduler)
    with capture_jax_draws() as draws:
        ref = JPipeline()(jm, **kw)
    got = StableDiffusionUnifiedPipeline(device="cpu")(tm, draws=draws, **kw)
    return got, ref


# the pipeline cases; test_torch_extensions_sdxl.py runs them on the SDXL
# model
PIPELINE_CASES = [
    dict(freeu=True),
    dict(freeu=[1.1, 1.2, 0.8, 0.5], scheduler="DPM++ 2M SDE Karras"),
    dict(pag_scale=3.0),
    dict(pag_scale=2.0, pag_applied_layers=["up", "down", "mid"], guidance_rescale=0.5),
    dict(pag_scale=3.0, guidance_scale=1.0),
    dict(cache_interval=3, freeu=True, scheduler="euler_a"),
]
PIPELINE_IDS = ["freeu", "freeu_tuple_sde", "pag", "pag_all_rescale", "pag_no_cfg",
                "deepcache3_tail_freeu_ancestral"]


def pipeline_case_matches_jax(jm, tm, kw):
    kw = dict(REQ, **kw)
    got, ref = _pipes(jm, tm, kw, kw.pop("scheduler", "euler"))
    _close(got.latents, ref.latents)


@pytest.mark.parametrize("kw", PIPELINE_CASES, ids=PIPELINE_IDS)
def test_pipeline_extensions_match_jax(sd15, kw):
    pipeline_case_matches_jax(*sd15, kw)
