"""PyTorch/CUDA port: SDXL and the SD2.x layout against the JAX package, in
fp32 on the CPU.

The tiny SDXL model of ``tests/torch_port_helpers.py`` (two CLIP towers,
linear projections, ``text_time`` micro-conditioning, two transformer layers
at one level, a refiner UNet) runs through the port and, with the same
weights, through the JAX package.  Modules and prompt encodes agree within
1e-4; whole pipeline calls, with the JAX call's own random draws captured and
injected through ``draws=``, within 1e-4 of max(1, max |ref|).  The
full-width SDXL UNet is checked for its parameter count and names on the meta
device, without weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.models import unet as junet
from stablediffusion_tpu.pipelines import unified as junified
from stablediffusion_tpu.pipelines.unified import (
    StableDiffusionUnifiedPipeline as JPipeline,
)
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.io.from_jax import flatten, to_torch_layout
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    _init,
    _jax_cfg,
    jax_tree,
    port_test_module,
    tiny_sdxl_port_model,
    tiny_sdxl_unet_config,
    to_jax_model,
)

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    tm = tiny_sdxl_port_model(seed=0, refiner=True)
    return to_jax_model(tm), tm


@pytest.fixture(scope="module")
def pipes():
    return JPipeline(do_cfg=True), StableDiffusionUnifiedPipeline(device="cpu")


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


@pytest.mark.parametrize("layout", ["sdxl", "sd2"])
def test_unet_matches_jax(layout):
    """sdxl: linear projections, per-level heads and depths, text_time over
    the pooled embeds and six time ids; sd2: linear projections and
    per-level heads, no addition embedding."""
    if layout == "sdxl":
        uc = tiny_sdxl_unet_config()
    else:
        uc = dataclasses.replace(tcfg.tiny_unet_config(), use_linear_projection=True,
                                 num_attention_heads=(2, 4))
    unet = _init(UNet2DConditionModel(uc), torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, uc.cross_attention_dim)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    added = None
    if layout == "sdxl":
        added = {"text_embeds": rng.standard_normal((2, 32)).astype(np.float32),
                 "time_ids": np.array([[32, 32, 0, 0, 32, 32], [64, 48, 4, 8, 64, 48]],
                                      np.float32)}
    ref = jax.jit(junet.apply, static_argnums=1)(
        jax_tree(unet), _jax_cfg(jcfg.UNetConfig, uc), jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx), added)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = unet(tx, torch.from_numpy(t), torch.from_numpy(ctx),
                   None if added is None else {k: torch.from_numpy(v) for k, v in added.items()})
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=ATOL)
    if layout == "sdxl":  # JAX asserts; the port raises
        with pytest.raises(ValueError, match="added_cond"):
            unet(tx, torch.from_numpy(t), torch.from_numpy(ctx))


def test_full_width_sdxl_unet_shape_matches_jax():
    """SDXL_UNET on the meta device: the JAX package's parameter count
    (``tests/test_models.py:136``) and its param tree's names and shapes in
    torch layouts."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(tcfg.SDXL_UNET)
    assert sum(p.numel() for p in unet.parameters()) == 2_567_463_684
    shapes = jax.eval_shape(lambda k: junet.init_params(k, jcfg.SDXL_UNET), jax.random.key(0))
    flat = flatten(jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                          shapes))
    sd = unet.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        assert tuple(sd[k].shape) == to_torch_layout(k, v).shape, k


@pytest.mark.parametrize("tower, clip_skip", [(2, 0), (2, 1), (1, 0)])
def test_clip_penultimate_and_pooled_match_jax(models, pipes, tower, clip_skip):
    """The "penultimate" mode (hidden_states[-(clip_skip + 2)], no final
    norm) and the pooled output: bigG's projected one, CLIP-L's plain."""
    jm, tm = models
    jpipe, tpipe = pipes
    texts = ["a cat", "a dog and a cat"]
    if tower == 2:
        tok, enc = tm.tokenizer_2, tm.text_encoder_2
        jtok, jcfg_, jpar = jm.tokenizer_2, jm.text_encoder_2_config, jm.text_encoder_2_params
    else:
        tok, enc = tm.tokenizer, tm.text_encoder
        jtok, jcfg_, jpar = jm.tokenizer, jm.text_encoder_config, jm.text_encoder_params
    np.testing.assert_array_equal(tok(texts), jtok(texts))
    rh, rp = junified._clip_encode(jpar, jnp.asarray(jtok(texts)), config=jcfg_,
                                   mode="penultimate", clip_skip=clip_skip)
    h, p = tpipe._clip_encode(tok, enc, texts, "penultimate", clip_skip)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=ATOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), atol=ATOL)


ENCODE_CASES = {
    "prompt_2": dict(prompt="a cat", prompt_2="a dog", negative_prompt="cat"),
    "clip_skip_lists": dict(prompt=["a cat", "a dog"], negative_prompt=["dog", "a"],
                            negative_prompt_2="cat", clip_skip=1, num_images_per_prompt=2),
    "refiner_mode": dict(prompt="a cat", prompt_2="a dog", negative_prompt_2="cat",
                         refiner_mode=True),
    "no_cfg": dict(prompt="a dog", do_cfg=False),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_prompt_matches_jax(models, pipes, case):
    jm, tm = models
    jpipe, tpipe = pipes
    ref = jpipe.encode_prompt(jm, **ENCODE_CASES[case])
    out = tpipe.encode_prompt(tm, **ENCODE_CASES[case])
    for a, b in zip(out, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("unet", ["base", "refiner"])
def test_add_time_ids_match_jax(models, pipes, unet):
    jm, tm = models
    jpipe, tpipe = pipes
    tc, jc = ((tm.unet_config, jm.unet_config) if unet == "base"
              else (tm.refiner_config, jm.refiner_config))
    ref = jpipe._add_time_ids(jm, jc, 48, 32, 3)
    out = tpipe._add_time_ids(tm, tc, 48, 32, 3)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # an add_embedding whose width fits neither layout raises in both
    bad_t = dataclasses.replace(tm.unet_config, projection_class_embeddings_input_dim=70)
    with pytest.raises(ValueError, match="add_embedding expects 70"):
        tpipe._add_time_ids(tm, bad_t, 48, 32, 3)
    with pytest.raises(ValueError, match="add_embedding expects 70"):
        jpipe._add_time_ids(jm, _jax_cfg(jcfg.UNetConfig, bad_t), 48, 32, 3)


def _image(seed, hw=32):
    return np.random.default_rng(seed).uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)


def _mask(hw=32):
    m = np.zeros((hw, hw), np.float32)
    m[hw // 4: 3 * hw // 4, hw // 4: 3 * hw // 4] = 1.0
    return m


# name -> (scheduler, request)
PIPELINE_CASES = {
    "txt2img_prompt_2_lists": ("DDIM", dict(
        prompt=["a cat", "a dog"], prompt_2=["dog", "cat"], negative_prompt="a",
        negative_prompt_2=["c", "d"], clip_skip=1, seed=[4, 5])),
    "img2img": ("euler_a", dict(prompt="a cat", image=_image(1), strength=0.6,
                                num_images_per_prompt=2)),
    "blend4": ("DPM++ 2M SDE Karras", dict(prompt="a dog", image=_image(2),
                                           mask_image=_mask(), strength=0.8)),
    "refiner_img2img": ("DPM++ 2M", dict(prompt="a cat", prompt_2="a dog", image=_image(3),
                                         strength=0.3, use_refiner=True)),
    "refiner_denoising_start": ("DDIM", dict(prompt="a cat", image=_image(4),
                                             denoising_start=0.5, use_refiner=True)),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_sdxl_pipeline_matches_jax(models, pipes, case):
    jm, tm = models
    jpipe, tpipe = pipes
    sched, req = PIPELINE_CASES[case]
    jm.set_scheduler(sched)
    tm.set_scheduler(sched)
    req = dict(req, num_inference_steps=6, guidance_scale=7.5, height=32, width=32)
    req.setdefault("seed", 9)
    out_type = "np" if "mask_image" in req else "latents"
    with capture_jax_draws() as draws:
        jout = jpipe(jm, output_type=out_type, **req)
    tout = tpipe(tm, output_type=out_type, draws=draws, **req)
    assert tout.seed == jout.seed
    out, ref = ((tout.latents.numpy(), np.asarray(jout.latents)) if out_type == "latents"
                else (tout.images, np.asarray(jout.images)))
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def test_pooled_prompt_embeds_match_jax(models, pipes):
    """Precomputed embeddings with pooled ones: no negative pooled means
    zeros under CFG, as in JAX; the same embeds give the same latents."""
    jm, tm = models
    jpipe, tpipe = pipes
    jm.set_scheduler("DDIM")
    tm.set_scheduler("DDIM")
    emb, neg, pooled, _ = tpipe.encode_prompt(tm, "a cat", negative_prompt="dog")
    req = dict(prompt_embeds=emb.numpy(), negative_prompt_embeds=neg.numpy(),
               pooled_prompt_embeds=pooled.numpy(), num_inference_steps=3,
               guidance_scale=7.5, height=32, width=32, seed=2, output_type="latents")
    with capture_jax_draws() as draws:
        ref = np.asarray(jpipe(jm, **req).latents)
    out = tpipe(tm, draws=draws, **req).latents.numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def test_use_refiner_needs_a_loaded_refiner(models, pipes):
    jm, tm = models
    jpipe, tpipe = pipes
    bare_t, bare_j = dataclasses.replace(tm, refiner=None), dataclasses.replace(
        jm, refiner_params=None)
    kw = dict(prompt="x", height=32, width=32, num_inference_steps=1, use_refiner=True)
    with pytest.raises(ValueError, match="no refiner loaded"):
        tpipe(bare_t, **kw)
    with pytest.raises(ValueError, match="no refiner loaded"):
        jpipe(bare_j, **kw)


def test_from_jax_carries_the_second_tower_and_the_refiner(models):
    """io/from_jax.load_from_jax takes the JAX trees of bigG and the refiner
    into fresh port modules with every tensor equal."""
    from stablediffusion_tpu_torch.io.from_jax import load_from_jax
    from stablediffusion_tpu_torch.models.clip import CLIPTextModel

    jm, tm = models
    pairs = ((CLIPTextModel(tm.text_encoder_2_config), jm.text_encoder_2_params,
              tm.text_encoder_2),
             (UNet2DConditionModel(tm.refiner_config), jm.refiner_params, tm.refiner))
    for fresh, tree, want in pairs:
        got = load_from_jax(fresh, jax.tree_util.tree_map(np.asarray, tree)).state_dict()
        ref = want.state_dict()
        assert got.keys() == ref.keys()
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
