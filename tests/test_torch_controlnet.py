"""PyTorch/CUDA port: ControlNet against the JAX package, in fp32 on the CPU.

``models/controlnet.ControlNetModel`` against ``controlnet.apply`` (SD1.5
layout, and the SDXL layout with its ``text_time`` embedding) and the UNet's
``down_block_residuals`` / ``mid_block_residual`` against ``unet.apply``,
within TOL; whole pipeline calls with ``control_image`` (with PAG, whose
extra branch takes the residuals' conditional half), the JAX draws injected,
within TOL of max(1, max |ref|); ControlNet folders both ways with the JAX
loader; ``init_from_unet`` leaving the UNet's output unchanged; the guard
without a loaded ControlNet.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.io import loader as jloader
from stablediffusion_tpu.models import controlnet as jcontrolnet
from stablediffusion_tpu.models import unet as junet
from stablediffusion_tpu.pipelines.unified import StableDiffusionUnifiedPipeline as JPipeline
from stablediffusion_tpu_torch.io.loader import load_controlnet, save_controlnet
from stablediffusion_tpu_torch.models.controlnet import ControlNetModel, init_from_unet
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.utils.testing import random_controlnet, write_controlnet_folder
from torch_port_helpers import (  # noqa: F401
    capture_jax_draws,
    jitted,
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

TOL = 1e-4


def _close(got, ref, tol=TOL):
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{family: (jax model, port model)}, each with the same random
    ControlNet loaded from one folder (written in fp32)."""
    out = {}
    for family, tm in (("sd15", tiny_port_model(seed=8)), ("sdxl", tiny_sdxl_port_model(seed=9))):
        folder = str(tmp_path_factory.mktemp(f"cn_{family}"))
        write_controlnet_folder(folder, tm.unet_config, device="cpu", dtype=torch.float32,
                                seed=10)
        tm.load_controlnet(folder)
        jm = to_jax_model(tm)
        jm.load_controlnet(folder)
        out[family] = (jm, tm)
    return out


def _inputs(tm, seed):
    cfg = tm.unet_config
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, cfg.cross_attention_dim)).astype(np.float32)
    cond = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        added = {"text_embeds": rng.standard_normal((2, pooled)).astype(np.float32),
                 "time_ids": np.tile(np.float32([32, 32, 0, 0, 32, 32]), (2, 1))}
    return x, ctx, cond, added


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_controlnet_and_unet_residuals_match_jax(models, family):
    jm, tm = models[family]
    x, ctx, cond, added = _inputs(tm, 1)
    jadded = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    tadded = None if added is None else {k: _t(v) for k, v in added.items()}
    jdown, jmid = jitted(jcontrolnet.apply, static_argnames=("conditioning_scale",))(
        jm.controlnet_params, jm.controlnet_config, jnp.asarray(x),
                                    jnp.asarray(400), jnp.asarray(ctx), jnp.asarray(cond),
                                    conditioning_scale=0.7, added_cond=jadded)
    with torch.no_grad():
        down, mid = tm.controlnet(_t(x).permute(0, 3, 1, 2), torch.tensor(400), _t(ctx),
                                  _t(cond).permute(0, 3, 1, 2), 0.7, tadded)
    assert len(down) == len(jdown)
    for d, jd in zip(down, jdown):
        _close(d.permute(0, 2, 3, 1), jd)
    _close(mid.permute(0, 2, 3, 1), jmid)
    ref = jitted(junet.apply)(jm.unet_params, jm.unet_config, jnp.asarray(x), jnp.asarray(400),
                      jnp.asarray(ctx), added_cond=jadded, down_block_residuals=jdown,
                      mid_block_residual=jmid)
    with torch.no_grad():
        got = tm.unet(_t(x).permute(0, 3, 1, 2), torch.tensor(400), _t(ctx), tadded,
                      down_block_residuals=down, mid_block_residual=mid)
    _close(got.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("family, kw", [
    ("sd15", dict()),
    ("sd15", dict(pag_scale=2.0, controlnet_conditioning_scale=0.5)),
    ("sd15", dict(guidance_scale=1.0, output_type="np")),
    ("sdxl", dict()),
    ("sdxl", dict(pag_scale=1.5, pag_applied_layers=("down", "mid"))),
], ids=["sd15", "sd15_pag_scale", "sd15_no_cfg_np", "sdxl", "sdxl_pag"])
def test_pipeline_control_image_matches_jax(models, family, kw):
    jm, tm = models[family]
    control = np.random.default_rng(2).uniform(0, 1, (40, 24, 3)).astype(np.float32)
    common = dict(prompt="a cat", negative_prompt="a dog", num_inference_steps=3,
                  guidance_scale=7.5, seed=4, height=32, width=32, output_type="latents",
                  control_image=control)
    common.update(kw)
    with capture_jax_draws() as draws:
        ref = JPipeline()(jm, **common)
    pipe = StableDiffusionUnifiedPipeline(device="cpu")
    got = pipe(tm, draws=draws, **common)
    key = "latents" if common["output_type"] == "latents" else "images"
    _close(getattr(got, key), getattr(ref, key))
    plain = pipe(tm, draws=draws, **{k: v for k, v in common.items() if k != "control_image"})
    assert not np.allclose(np.asarray(getattr(plain, key)), np.asarray(getattr(got, key)),
                           atol=1e-3)


def test_controlnet_folders_both_ways(models, tmp_path):
    jm, tm = models["sdxl"]
    ours = str(tmp_path / "ours")
    save_controlnet(tm.controlnet, tm.controlnet_config, ours)
    jparams = jloader.load_component_state(ours)
    from stablediffusion_tpu_torch.io.from_jax import flatten, to_torch_layout

    state = tm.controlnet.state_dict()
    flat = flatten(jparams)
    assert sorted(flat) == sorted(state)
    for k, v in flat.items():
        np.testing.assert_array_equal(to_torch_layout(k, np.asarray(v)), state[k].numpy())
    theirs = str(tmp_path / "theirs")
    jloader.save_controlnet(jm.controlnet_params, jm.controlnet_config, theirs)
    cfg, net = load_controlnet(theirs, torch.device("cpu"), torch.float32)
    assert cfg == tm.controlnet_config
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_init_from_unet_leaves_the_unet_unchanged(models, family):
    _, tm = models[family]
    net = init_from_unet(tm.unet, tm.unet_config, torch.Generator().manual_seed(0))
    assert isinstance(net, ControlNetModel)
    for k, v in net.state_dict().items():
        if k.split(".")[0] in ("conv_in", "down_blocks", "mid_block", "time_embedding"):
            assert torch.equal(v, tm.unet.state_dict()[k]), k
    x, ctx, cond, added = _inputs(tm, 3)
    tadded = None if added is None else {k: _t(v) for k, v in added.items()}
    with torch.no_grad():
        down, mid = net(_t(x).permute(0, 3, 1, 2), torch.tensor(10), _t(ctx),
                        _t(cond).permute(0, 3, 1, 2), 1.0, tadded)
        assert all(not r.any() for r in down) and not mid.any()
        base = tm.unet(_t(x).permute(0, 3, 1, 2), torch.tensor(10), _t(ctx), tadded)
        with_res = tm.unet(_t(x).permute(0, 3, 1, 2), torch.tensor(10), _t(ctx), tadded,
                           down_block_residuals=down, mid_block_residual=mid)
    assert torch.equal(base, with_res)


def test_random_controlnet_is_seeded_and_not_zero():
    cfg = tiny_port_model().unet_config
    a = random_controlnet(cfg, "cpu", torch.float32, seed=3)
    b = random_controlnet(cfg, "cpu", torch.float32, seed=3)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.controlnet_mid_block.weight.abs().sum() > 0


def test_control_image_without_a_controlnet_raises():
    tm = tiny_port_model(seed=1)
    jm = to_jax_model(tm)
    kw = dict(prompt="x", num_inference_steps=1, height=32, width=32,
              control_image=np.zeros((32, 32, 3), np.float32))
    for pipe, m in ((JPipeline(), jm), (StableDiffusionUnifiedPipeline(device="cpu"), tm)):
        with pytest.raises(ValueError, match="no ControlNet loaded"):
            pipe(m, **kw)


def test_load_from_jax_fills_a_controlnet(models):
    """``io/from_jax.load_from_jax`` carries the JAX package's ControlNet tree
    (HWIO convolutions) into the module: the tensors of the loaded folder."""
    from stablediffusion_tpu_torch.io.from_jax import load_from_jax

    jm, tm = models["sd15"]
    with torch.device("meta"):
        net = ControlNetModel(tm.controlnet_config)
    net = load_from_jax(net.to_empty(device="cpu"), jm.controlnet_params)
    for k, v in net.state_dict().items():
        assert torch.equal(v, tm.controlnet.state_dict()[k]), k
