"""PyTorch/CUDA port: the SD3 family against the JAX package, in fp32 on the
CPU.

The tiny SD3 model of ``tests/torch_port_helpers.py`` (a two-block MM-DiT,
CLIP-L-like and bigG-like towers with projections, a T5, an SD3-style VAE
with a latent shift and no quant convs) runs through the port and, with the
same weights, through the JAX package.  Modules agree within 1e-4 (the
MM-DiT in its plain, ``qk_norm``, MMDiT-X ``dual`` and odd-crop forms; the
last block is always ``context_pre_only``); whole pipeline calls, with the
JAX call's own draws captured and injected through ``draws=``, within 1e-4
of max(1, max |ref|).  SD3 folders load both ways with every tensor equal,
with and without ``text_encoder_3``, and an SD3 request runs through the
CPU handler and the batcher.
"""

import dataclasses
import logging
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.io import loader as jloader
from stablediffusion_tpu.models import clip as jclip
from stablediffusion_tpu.models import mmdit as jmmdit
from stablediffusion_tpu.pipelines import sd3 as jsd3
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.io import loader
from stablediffusion_tpu_torch.io.from_jax import flatten, load_from_jax
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel
from stablediffusion_tpu_torch.models.vae import (
    AutoencoderKL,
    denormalize_latents,
    normalize_latents,
)
from stablediffusion_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline
from stablediffusion_tpu_torch.serve.batcher import Batcher
from stablediffusion_tpu_torch.serve.handler import (
    Handler,
    decode_image_b64,
    encode_images_b64,
)
from torch_port_helpers import (  # noqa: F401
    capture_jax_sd3_draws,
    _init,
    _jax_cfg,
    _jax_noise,
    jax_tree,
    port_test_module,
    tiny_sd3_port_model,
    to_jax_sd3_model,
)

ATOL = 1e-4
# every pipeline call of this file: 3 flow-match steps at 16x16 pixels (8x8
# latents), T5 at 16 tokens, CFG 5
KW = dict(num_inference_steps=3, height=16, width=16, max_sequence_length=16,
          guidance_scale=5.0)


@pytest.fixture(scope="module")
def models():
    tm = tiny_sd3_port_model(seed=0, dual=(0,), qk_norm="rms_norm")
    return to_jax_sd3_model(tm), tm


def _close(out, ref, scale_floor=1.0):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    tol = ATOL * max(scale_floor, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize(
    "name", ["SD3_MEDIUM", "SD35_LARGE", "SD35_MEDIUM", "tiny_sd3_config", "SD3_VAE",
             "SD3Config"])
def test_sd3_configs_match_jax(name):
    get = lambda mod: getattr(mod, name)() if callable(getattr(mod, name)) \
        else getattr(mod, name)  # noqa: E731
    assert dataclasses.asdict(get(tcfg)) == dataclasses.asdict(get(jcfg))


def test_sd3_config_from_diffusers_dict_matches_jax():
    d = {"_class_name": "SD3Transformer2DModel", "num_layers": 24, "qk_norm": "rms_norm",
         "dual_attention_layers": [0, 1, 2], "pos_embed_max_size": 384, "sample_size": 128}
    assert (dataclasses.asdict(tcfg.SD3Config.from_diffusers_dict(d))
            == dataclasses.asdict(jcfg.SD3Config.from_diffusers_dict(d)))
    v = {"latent_channels": 16, "scaling_factor": 1.5305, "shift_factor": 0.0609,
         "use_quant_conv": False, "use_post_quant_conv": False}
    assert (dataclasses.asdict(tcfg.VAEConfig.from_diffusers_dict(v))
            == dataclasses.asdict(jcfg.VAEConfig.from_diffusers_dict(v)))


def _mmdit_inputs(cfg, B, H, W, S_txt, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, H, W, cfg.in_channels)).astype(np.float32)
    ctx = r.standard_normal((B, S_txt, cfg.joint_attention_dim)).astype(np.float32)
    pooled = r.standard_normal((B, cfg.pooled_projection_dim)).astype(np.float32)
    t = np.array([999.0, 37.5][:B], np.float32)
    return x, t, ctx, pooled


def _mmdit_pair(cfg, x, t, ctx, pooled, seed=0):
    """(port output NHWC, JAX output) of the same weights and inputs."""
    model = _init(SD3Transformer2DModel(cfg), torch.Generator().manual_seed(seed))
    ref = jmmdit.apply(jax_tree(model), _jax_cfg(jcfg.SD3Config, cfg), jnp.asarray(x),
                       jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(pooled))
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                torch.from_numpy(ctx), torch.from_numpy(pooled))
    return out.permute(0, 2, 3, 1).numpy(), np.asarray(ref)


@pytest.mark.parametrize("variant, hw", [
    ("plain", (8, 8)),
    ("qk_norm", (8, 8)),
    ("dual", (8, 8)),
    ("dual_qk_norm_three_blocks", (8, 8)),
    ("odd_crop", (10, 14)),  # 5 x 7 patches of the 16 x 16 grid
    ("scalar_timestep", (6, 6)),
])
def test_mmdit_matches_jax(variant, hw):
    cfg = tcfg.tiny_sd3_config()
    if "qk_norm" in variant:
        cfg = dataclasses.replace(cfg, qk_norm="rms_norm")
    if variant.startswith("dual"):
        cfg = dataclasses.replace(cfg, dual_attention_layers=(0,))
    if "three_blocks" in variant:
        cfg = dataclasses.replace(cfg, num_layers=3, dual_attention_layers=(0, 2))
    x, t, ctx, pooled = _mmdit_inputs(cfg, 2, *hw, S_txt=9, seed=1)
    if variant == "scalar_timestep":
        t = np.array(412.0, np.float32)
    out, ref = _mmdit_pair(cfg, x, t, ctx, pooled)
    assert out.shape == (2, *hw, cfg.out_channels)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_mmdit_from_jax_tree():
    """A tree in the layout of the JAX package's own ``mmdit.init_params``
    (its names and shapes by ``jax.eval_shape``: HWIO patch kernel, (in,
    out) linears, the [1, positions, D] table; random values) loads through
    ``io/from_jax.load_from_jax``, and the two forwards agree."""
    cfg = dataclasses.replace(tcfg.tiny_sd3_config(), qk_norm="rms_norm",
                              dual_attention_layers=(0,))
    jc = _jax_cfg(jcfg.SD3Config, cfg)
    shapes = jax.eval_shape(lambda: jmmdit.init_params(jax.random.key(3), jc))
    r = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: (0.1 * r.standard_normal(a.shape)).astype(np.float32), shapes)
    model = load_from_jax(SD3Transformer2DModel(cfg), tree)
    x, t, ctx, pooled = _mmdit_inputs(cfg, 2, 8, 8, S_txt=5, seed=4)
    ref = np.asarray(jmmdit.apply(tree, jc, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                  jnp.asarray(pooled)))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                    torch.from_numpy(ctx), torch.from_numpy(pooled)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_full_size_mmdit_layout_on_meta():
    """SD3-medium and SD3.5-medium at full width on the meta device: the
    parameter counts (those of the JAX package's trees, by
    ``jax.eval_shape`` of ``mmdit.init_params``) and the names of the
    MMDiT-X and context_pre_only blocks."""
    with torch.device("meta"):
        medium = SD3Transformer2DModel(tcfg.SD3_MEDIUM)
        mx = SD3Transformer2DModel(tcfg.SD35_MEDIUM)
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(medium) == 2_084_951_104
    assert count(mx) == 2_469_663_936
    names = dict(mx.named_parameters())
    assert "transformer_blocks.12.attn2.norm_q.weight" in names
    assert "transformer_blocks.13.attn2.to_q.weight" not in names
    assert names["transformer_blocks.12.norm1.linear.weight"].shape == (9 * 1536, 1536)
    assert "transformer_blocks.23.attn.to_add_out.weight" not in names
    assert "transformer_blocks.23.ff_context.net.0.proj.weight" not in names
    assert names["transformer_blocks.23.norm1_context.linear.weight"].shape == (2 * 1536, 1536)
    assert names["pos_embed.pos_embed"].shape == (1, 384 * 384, 1536)


def test_sd3_vae_matches_jax():
    """The 16-channel-style VAE without quant convs: encode with the shift
    and scale (the JAX draw injected) and decode, against
    ``_sd3_vae_encode`` / ``_sd3_vae_decode``."""
    vc = dataclasses.replace(tcfg.tiny_vae_config(), latent_channels=16, use_quant_conv=False,
                             use_post_quant_conv=False, shift_factor=0.0609,
                             scaling_factor=1.5305)
    vae = _init(AutoencoderKL(vc), torch.Generator().manual_seed(2))
    assert not any("quant_conv" in k for k in vae.state_dict())
    jc, tree = _jax_cfg(jcfg.VAEConfig, vc), jax_tree(vae)
    img = np.random.default_rng(5).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(9)
    ref_z = np.asarray(jsd3._sd3_vae_encode(tree, jnp.asarray(img), key, config=jc))
    eps = torch.from_numpy(_jax_noise(key, ref_z.shape)).permute(0, 3, 1, 2)
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(img).permute(0, 3, 1, 2))
        z = normalize_latents(mean + torch.exp(0.5 * logvar) * eps, vc)
        np.testing.assert_allclose(z.permute(0, 2, 3, 1).numpy(), ref_z, atol=ATOL, rtol=0)
        ref_px = np.asarray(jsd3._sd3_vae_decode(tree, jnp.asarray(ref_z), config=jc))
        px = vae.decode(denormalize_latents(torch.from_numpy(ref_z.copy()).permute(0, 3, 1, 2), vc))
    np.testing.assert_allclose(px.permute(0, 2, 3, 1).numpy(), ref_px, atol=ATOL, rtol=0)
    z = torch.randn(2, 16, 4, 4)
    torch.testing.assert_close(normalize_latents(denormalize_latents(z, vc), vc), z)


def test_clip_l_with_projection_at_768():
    """SD3's CLIP-L is a WithProjection tower at width 768: the projected
    pooled output against ``clip.apply`` (one layer, full width)."""
    cfg = dataclasses.replace(tcfg.SDXL_TEXT_ENCODER, with_projection=True,
                              num_hidden_layers=1)
    enc = _init(CLIPTextModel(cfg), torch.Generator().manual_seed(4))
    assert enc.text_projection.weight.shape == (768, 768)
    ids = np.full((2, 77), 49407, np.int32)
    ids[:, 0] = 49406
    ids[0, 1:6] = [320, 1125, 539, 550, 49407]
    ids[1, 1:3] = [1929, 49407]
    ref = jclip.apply(jax_tree(enc), _jax_cfg(jcfg.CLIPTextConfig, cfg), jnp.asarray(ids))
    with torch.no_grad():
        out = enc(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.projected_pooled.numpy(),
                               np.asarray(ref.projected_pooled), atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_t5, clip_skip", [(True, None), (False, 1)])
def test_encode_prompt_matches_jax(models, with_t5, clip_skip):
    jm, tm = models
    if not with_t5:
        jm = dataclasses.replace(jm, text_encoder_3_config=None, text_encoder_3_params=None,
                                 tokenizer_3=None)
        tm = dataclasses.replace(tm, text_encoder_3_config=None, text_encoder_3=None,
                                 tokenizer_3=None)
    args = (["a cat", "a dog running"], "by the sea", None, "blurry", None, "dark")
    kw = dict(num_images_per_prompt=2, max_sequence_length=16, clip_skip=clip_skip)
    refs = jsd3.StableDiffusion3Pipeline().encode_prompt(jm, *args, **kw)
    outs = StableDiffusion3Pipeline(device="cpu").encode_prompt(tm, *args, **kw)
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert outs[0].shape == (4, 77 + 16, tm.joint_dim) and outs[2].shape == (4, 20)
    if not with_t5:
        assert not outs[0][:, 77:].any()


_IMG = (np.random.default_rng(1).random((1, 16, 16, 3))).astype(np.float32)
_MASK = np.zeros((1, 16, 16, 1), np.float32)
_MASK[:, 4:12, 4:12] = 1.0


@pytest.mark.parametrize("mode", ["txt2img", "img2img", "inpaint", "t5_free", "seed_list",
                                  "negatives_batch2"])
def test_pipeline_matches_jax(models, mode):
    """One call of each mode, the JAX call's draws captured and injected;
    images, and for txt2img the latents too."""
    jm, tm = models
    kw = dict(KW, prompt="a cat", seed=5)
    if mode == "img2img":
        kw.update(image=_IMG, strength=0.6)
    elif mode == "inpaint":
        kw.update(image=_IMG, mask_image=_MASK, strength=0.8)
    elif mode == "t5_free":
        jm = dataclasses.replace(jm, text_encoder_3_config=None, text_encoder_3_params=None,
                                 tokenizer_3=None)
        tm = dataclasses.replace(tm, text_encoder_3_config=None, text_encoder_3=None,
                                 tokenizer_3=None)
    elif mode == "seed_list":
        kw.update(prompt=["a cat", "a dog"], seed=[3, 4], prompt_3="in the snow")
    elif mode == "negatives_batch2":
        kw.update(prompt=["a cat", "a dog"], negative_prompt=["blurry", "dark"],
                  negative_prompt_2="low quality", prompt_2="by the sea")
    outputs = ("np", "latents") if mode == "txt2img" else ("np",)
    for output_type in outputs:
        with capture_jax_sd3_draws() as draws:
            ref = jsd3.StableDiffusion3Pipeline()(jm, output_type=output_type, **kw)
        out = StableDiffusion3Pipeline(device="cpu")(tm, output_type=output_type,
                                                      draws=draws, **kw)
        assert out.seed == ref.seed
        if output_type == "latents":
            _close(out.latents.numpy(), ref.latents)
        else:
            _close(out.images, ref.images)


def test_pipeline_options(models):
    """uint8 on the device and on the host agree, the tiled decode takes the
    one-tile path at this size, a custom sigma list follows JAX, prompt
    weighting on a prompt without markup gives the plain image, and the
    adapter and int8 options fail as JAX's do."""
    jm, tm = models
    pipe = StableDiffusion3Pipeline(device="cpu")
    kw = dict(KW, prompt="a cat", seed=7)
    dev = pipe(tm, output_type="uint8_device", **kw).images
    host = pipe(tm, output_type="uint8", **kw).images
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_array_equal(pipe(tm, output_type="uint8", vae_tiling=True, **kw).images,
                                  host)
    sig = dict(kw, sigmas=[1.0, 0.6, 0.2])
    with capture_jax_sd3_draws() as draws:
        ref = jsd3.StableDiffusion3Pipeline()(jm, output_type="latents", **sig)
    _close(pipe(tm, output_type="latents", draws=draws, **sig).latents.numpy(), ref.latents)
    # prompt weighting is ported (its parity cases are in
    # test_torch_prompt_weights.py): a prompt without markup encodes as the
    # plain call does
    np.testing.assert_array_equal(pipe(tm, output_type="uint8", prompt_weighting=True,
                                       **kw).images, host)
    # SD3 adapters and quantization are ported (their parity cases are in
    # test_torch_sd3_lora.py and test_torch_quant.py): a missing file, an
    # unknown adapter and an empty one, and a mode set and reverted
    with pytest.raises(FileNotFoundError, match="sd3_x.safetensors"):
        tm.load_loras({"x": 1.0})
    with pytest.raises(ValueError, match="unknown adapters"):
        tm.set_adapters({"x": 1.0})
    tm.load_lora_weights("x", {})
    tm.set_adapters({"x": 1.0})
    assert tm.get_list_adapters() == {"x": 1.0}
    tm.quantize("w8")
    assert tm.quant_mode == "w8"
    tm.quantize(None)
    tm.delete_adapters()  # nothing loaded: a no-op, as in JAX
    assert tm.get_list_adapters() == {}
    with pytest.raises(ValueError, match="mask_image"):
        pipe(tm, mask_image=_MASK, **kw)


def _write_clip_tokenizers(path):
    from test_loader import _write_tokenizer_files

    _write_tokenizer_files(os.path.join(path, "tokenizer"))
    _write_tokenizer_files(os.path.join(path, "tokenizer_2"), pad_token="!")


@pytest.mark.parametrize("with_t5", [True, False])
def test_sd3_folders_both_ways(models, tmp_path, with_t5):
    """A port folder loads in the JAX package and a JAX folder in the port,
    every tensor equal, with and without text_encoder_3 (whose tokenizer
    gives the same ids); then the port's txt2img from the JAX folder equals
    the port's from its own model."""
    jm, tm = models
    if not with_t5:
        jm = dataclasses.replace(jm, text_encoder_3_config=None, text_encoder_3_params=None,
                                 tokenizer_3=None)
        tm = dataclasses.replace(tm, text_encoder_3_config=None, text_encoder_3=None,
                                 tokenizer_3=None)
    comps = ["transformer", "vae", "text_encoder", "text_encoder_2"]
    comps += ["text_encoder_3"] if with_t5 else []
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    loader.save_sd3_model(tm, port_dir)
    _write_clip_tokenizers(port_dir)
    from_port = jloader.load_sd3_model(port_dir, variant=None)
    assert from_port.transformer_config == jm.transformer_config
    assert (from_port.text_encoder_3_params is None) == (not with_t5)
    for comp in comps:
        got, want = flatten(getattr(from_port, f"{comp}_params")), flatten(jax_tree(getattr(tm, comp)))
        assert sorted(got) == sorted(want), comp
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    jloader.save_sd3_model(jm, jax_dir)
    _write_clip_tokenizers(jax_dir)
    from_jax = loader.load_sd3_model(jax_dir, device="cpu", variant=None)
    assert from_jax.transformer_config == tm.transformer_config
    assert (from_jax.text_encoder_3 is None) == (not with_t5)
    for comp in comps:
        a, b = getattr(tm, comp).state_dict(), getattr(from_jax, comp).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (comp, k)
    if with_t5:
        text = "a photograph of an astronaut riding a horse <extra_id_0>"
        np.testing.assert_array_equal(from_jax.tokenizer_3(text, max_length=24),
                                      tm.tokenizer_3(text, max_length=24))
    pipe = StableDiffusion3Pipeline(device="cpu", output_type="uint8")
    np.testing.assert_array_equal(pipe(from_jax, prompt="a cat", seed=2, **KW).images,
                                  pipe(tm, prompt="a cat", seed=2, **KW).images)
    with pytest.raises(ValueError, match="load_sd3_model"):
        loader.load_sd_model(port_dir, model_type="sd3", device="cpu")


def test_sd3_request_through_the_handler(models, tmp_path, caplog):
    """A model block {"type": "sd3", "name": N} loads <model_dir>/sd3_N; an
    SDXL payload's keys that SD3 does not take are dropped with a warning;
    img2img and inpainting through base64; SD3's unported model-block keys
    answer on the error channel."""
    _, tm = models
    loader.save_sd3_model(tm, str(tmp_path / "sd3_tiny"))
    h = Handler(model_dir=str(tmp_path), device="cpu")
    req = dict(KW, prompt="a cat", seed=11, prompt_3="in the snow", guidance_rescale=0.7,
               denoising_end=0.8)
    with caplog.at_level(logging.WARNING):
        resp = h({**req, "model": {"type": "sd3", "name": "tiny"}}, "sd3")
    assert "error" not in resp, resp.get("traceback")
    assert h.model.model_type == "sd3" and h.model.path == str(tmp_path / "sd3_tiny")
    assert "ignoring unsupported args ['denoising_end', 'guidance_rescale']" in caplog.text
    direct = StableDiffusion3Pipeline(device="cpu", output_type="uint8")(
        h.model, prompt="a cat", seed=11, prompt_3="in the snow", **KW)
    assert resp["images"] == encode_images_b64(direct.images)
    for extra in (dict(image=resp["images"][0], strength=0.5),
                  dict(image=resp["images"][0], mask_image=resp["images"][0], strength=0.9)):
        out = h({**KW, "prompt": "a dog", "seed": 12, **extra}, "mode")
        assert "error" not in out, out.get("traceback")
        assert decode_image_b64(out["images"][0]).shape == (16, 16, 3)
    # SD3 LoRAs and quantize are ported: a missing LoRA file and a bad mode
    # answer on the error channel
    for block, what in (({"loras": {"x": 1.0}}, "sd3_x.safetensors"),
                        ({"textual_inversion": ["x.pt"]}, "not supported"),
                        ({"quantize": "int4"}, "unknown quant mode")):
        err = h({**KW, "prompt": "a cat", "seed": 1, "model": block}, "err")
        assert "error" in err and what in err["error"], err
    assert "error" not in h({**KW, "prompt": "a cat", "seed": 1,
                             "model": {"loras": [], "textual_inversion": []}}, "clear")
    # the JAX handler has no SD3 train route either: the refusal names the
    # SD3 trainer
    err = h({"mode": "train", "train": {"data_dir": "x"}}, "train")
    assert "error" in err and "sd3_train.SD3LoRATrainer" in err["error"]


def test_batcher_merges_an_sd3_burst(models):
    """Two concurrent SD3 requests merge into one pipeline call (a prompt
    list and a seed list), and each image equals the request served alone
    within one uint8 level."""
    _, tm = models
    h = Handler(model=tm)
    b = Batcher(h, max_batch=2, window_ms=200.0, adaptive=False)
    results = {}

    def go(seed):
        results[seed] = b.submit(dict(KW, prompt=f"a cat {seed}", seed=seed), f"b{seed}")

    threads = [threading.Thread(target=go, args=(s,)) for s in (21, 22)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert b.merged_calls == 1
    for s in (21, 22):
        assert "error" not in results[s], results[s].get("traceback")
        assert results[s]["seed"] == s and results[s]["batched"] == 2
    solo = b.submit(dict(KW, prompt="a cat 22", seed=22), "solo")
    assert solo["batched"] == 1
    np.testing.assert_allclose(decode_image_b64(results[22]["images"][0]),
                               decode_image_b64(solo["images"][0]), atol=1.0 / 255 + 1e-6)
    b.close()
