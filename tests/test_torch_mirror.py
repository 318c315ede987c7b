"""UNet/VAE external numeric anchor: forward allclose vs the independent
torch mirror (tests/torch_mirror.py), with weights flowing through the real
torch->TPU converter (io/torch_convert.convert_state_dict).

This is the full-model analog of test_clip's transformers anchor: any
transpose or block-wiring error inside models/unet.py / models/vae.py (or a
converter layout bug) breaks these comparisons.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core.config import tiny_unet_config, tiny_vae_config
from stablediffusion_tpu.io.torch_convert import convert_state_dict
from stablediffusion_tpu.models import unet, vae

from torch_mirror import MirrorControlNet, MirrorUNet, MirrorVAE
from torch_port_helpers import port_test_module  # noqa: F401


def _params_from_torch(module):
    flat = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    return convert_state_dict(flat)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.transpose(x_nhwc, (0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("variant", ["sd15", "sd15_inpaint", "sdxl"])
def test_unet_forward_matches_torch_mirror(variant, rng):
    torch.manual_seed(0)
    sdxl = variant == "sdxl"
    in_ch = 9 if variant == "sd15_inpaint" else 4
    cfg = tiny_unet_config(in_channels=in_ch, sdxl=sdxl)
    if sdxl:
        # uneven per-block heads + stacked transformer layers, like SDXL
        cfg = dataclasses.replace(
            cfg, num_attention_heads=(2, 4), transformer_layers_per_block=(1, 2)
        )
    mirror = MirrorUNet(cfg).eval()
    params = _params_from_torch(mirror)

    B = 2
    sample = rng.standard_normal((B, 16, 16, in_ch)).astype(np.float32)
    embeds = rng.standard_normal((B, 7, cfg.cross_attention_dim)).astype(np.float32)
    t = np.asarray([500.0, 21.0], np.float32)
    added = None
    kwargs = {}
    if sdxl:
        pooled_dim = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        text_embeds = rng.standard_normal((B, pooled_dim)).astype(np.float32)
        time_ids = np.asarray([[16, 16, 0, 0, 16, 16]] * B, np.float32)
        added = {
            "text_embeds": jnp.asarray(text_embeds),
            "time_ids": jnp.asarray(time_ids),
        }
        kwargs = {
            "text_embeds": torch.from_numpy(text_embeds),
            "time_ids": torch.from_numpy(time_ids),
        }

    ours = unet.apply(
        params, cfg, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(embeds),
        added_cond=added,
    )
    with torch.no_grad():
        theirs = mirror(
            _nchw(sample), torch.from_numpy(t), torch.from_numpy(embeds), **kwargs
        )
    np.testing.assert_allclose(
        np.asarray(ours), _nhwc(theirs), atol=2e-4, rtol=2e-4,
        err_msg=f"UNet forward diverges from torch mirror ({variant})",
    )


def test_vae_roundtrip_matches_torch_mirror(rng):
    torch.manual_seed(1)
    cfg = tiny_vae_config()
    mirror = MirrorVAE(cfg).eval()
    params = _params_from_torch(mirror)

    image = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    mean_j, logvar_j = vae.encode(params, cfg, jnp.asarray(image))
    with torch.no_grad():
        mean_t, logvar_t = mirror.encode(_nchw(image))
    np.testing.assert_allclose(
        np.asarray(mean_j), _nhwc(mean_t), atol=2e-4, rtol=2e-4,
        err_msg="VAE encoder mean diverges from torch mirror",
    )
    np.testing.assert_allclose(
        np.asarray(logvar_j), _nhwc(logvar_t), atol=2e-4, rtol=2e-4,
        err_msg="VAE encoder logvar diverges from torch mirror",
    )

    latents = rng.standard_normal(
        (2, 32 // cfg.vae_scale_factor, 32 // cfg.vae_scale_factor,
         cfg.latent_channels)
    ).astype(np.float32)
    img_j = vae.decode(params, cfg, jnp.asarray(latents))
    with torch.no_grad():
        img_t = mirror.decode(_nchw(latents))
    np.testing.assert_allclose(
        np.asarray(img_j), _nhwc(img_t), atol=2e-4, rtol=2e-4,
        err_msg="VAE decoder diverges from torch mirror",
    )


def test_anchor_catches_wiring_mutations(rng):
    """Sanity that the anchor has teeth: swapping two converted weights makes
    the comparison fail (i.e. the test is sensitive to real wiring bugs)."""
    torch.manual_seed(2)
    cfg = tiny_unet_config()
    mirror = MirrorUNet(cfg).eval()
    params = _params_from_torch(mirror)
    # simulate a q/k wiring bug
    attn = params["mid_block"]["attentions"]["0"]["transformer_blocks"]["0"]["attn1"]
    attn["to_q"], attn["to_k"] = attn["to_k"], attn["to_q"]

    B = 2
    sample = rng.standard_normal((B, 16, 16, 4)).astype(np.float32)
    embeds = rng.standard_normal((B, 7, cfg.cross_attention_dim)).astype(np.float32)
    t = np.asarray([500.0, 21.0], np.float32)
    ours = unet.apply(
        params, cfg, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(embeds)
    )
    with torch.no_grad():
        theirs = mirror(_nchw(sample), torch.from_numpy(t), torch.from_numpy(embeds))
    assert np.abs(np.asarray(ours) - _nhwc(theirs)).max() > 1e-3


# ---------------------------------------------------------------------------
# SD3 MM-DiT anchor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "qk_norm,dual",
    [(None, ()), ("rms_norm", ()), ("rms_norm", (0,)), (None, (0, 1))],
)
def test_mmdit_forward_matches_torch_mirror(qk_norm, dual, rng):
    from stablediffusion_tpu.core.config import tiny_sd3_config
    from stablediffusion_tpu.models import mmdit
    from torch_mirror import MirrorMMDiT

    if qk_norm == "rms_norm" and not hasattr(torch.nn, "RMSNorm"):
        pytest.skip("torch too old for nn.RMSNorm")
    torch.manual_seed(0)
    cfg = dataclasses.replace(
        tiny_sd3_config(), qk_norm=qk_norm, dual_attention_layers=dual
    )
    mirror = MirrorMMDiT(cfg).eval()
    params = _params_from_torch(mirror)

    B = 2
    sample = rng.standard_normal((B, 8, 8, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((B, 9, cfg.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((B, cfg.pooled_projection_dim)).astype(np.float32)
    t = np.asarray([800.0, 41.5], np.float32)

    with torch.no_grad():
        ref = mirror(
            _nchw(sample),
            torch.from_numpy(t),
            torch.from_numpy(ctx),
            torch.from_numpy(pooled),
        )
    out = mmdit.apply(
        params, cfg, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(pooled),
    )
    np.testing.assert_allclose(
        np.asarray(out), _nhwc(ref), atol=2e-4, rtol=2e-4
    )


def test_mmdit_init_params_tree_matches_converter(rng):
    """init_params must produce the same tree structure the converter yields
    from a torch checkpoint (so random-init tests exercise real layouts)."""
    import jax

    from stablediffusion_tpu.core.config import tiny_sd3_config
    from stablediffusion_tpu.models import mmdit
    from torch_mirror import MirrorMMDiT

    cfg = tiny_sd3_config()
    torch.manual_seed(0)
    converted = _params_from_torch(MirrorMMDiT(cfg).eval())
    # the tree and its leaves' shapes, traced without computing the weights
    inited = jax.eval_shape(lambda: mmdit.init_params(jax.random.key(0), cfg))
    assert jax.tree_util.tree_structure(converted) == (
        jax.tree_util.tree_structure(inited)
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(converted), jax.tree_util.tree_leaves(inited)
    ):
        assert a.shape == b.shape


@pytest.mark.parametrize("variant", ["sd15", "sdxl"])
def test_controlnet_residuals_match_torch_mirror(variant, rng):
    """ControlNet forward anchor: per-skip and mid residuals allclose vs the
    independent MirrorControlNet (random — not zero — projection convs, so
    the conditioning embedder, trunk, and every 1x1 projection all carry
    signal), weights through the real converter."""
    from stablediffusion_tpu.models import controlnet

    torch.manual_seed(2)
    sdxl = variant == "sdxl"
    cfg = tiny_unet_config(sdxl=sdxl)
    if sdxl:
        cfg = dataclasses.replace(
            cfg, num_attention_heads=(2, 4), transformer_layers_per_block=(1, 2)
        )
    mirror = MirrorControlNet(cfg).eval()
    params = _params_from_torch(mirror)

    B = 2
    sample = rng.standard_normal((B, 16, 16, 4)).astype(np.float32)
    embeds = rng.standard_normal((B, 7, cfg.cross_attention_dim)).astype(np.float32)
    cond = rng.uniform(size=(B, 128, 128, 3)).astype(np.float32)
    t = np.asarray([500.0, 21.0], np.float32)
    added = None
    kwargs = {}
    if sdxl:
        pooled_dim = (
            cfg.projection_class_embeddings_input_dim
            - 6 * cfg.addition_time_embed_dim
        )
        text_embeds = rng.standard_normal((B, pooled_dim)).astype(np.float32)
        time_ids = np.asarray([[16, 16, 0, 0, 16, 16]] * B, np.float32)
        added = {
            "text_embeds": jnp.asarray(text_embeds),
            "time_ids": jnp.asarray(time_ids),
        }
        kwargs = {
            "text_embeds": torch.from_numpy(text_embeds),
            "time_ids": torch.from_numpy(time_ids),
        }

    ours_down, ours_mid = controlnet.apply(
        params, cfg, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(embeds),
        jnp.asarray(cond), conditioning_scale=0.7, added_cond=added,
    )
    with torch.no_grad():
        theirs_down, theirs_mid = mirror(
            _nchw(sample), torch.from_numpy(t), torch.from_numpy(embeds),
            _nchw(cond), conditioning_scale=0.7, **kwargs
        )
    assert len(ours_down) == len(theirs_down)
    for i, (a, b) in enumerate(zip(ours_down, theirs_down)):
        np.testing.assert_allclose(
            np.asarray(a), _nhwc(b), atol=2e-4, rtol=2e-4,
            err_msg=f"ControlNet down residual {i} diverges ({variant})",
        )
    np.testing.assert_allclose(
        np.asarray(ours_mid), _nhwc(theirs_mid), atol=2e-4, rtol=2e-4,
        err_msg=f"ControlNet mid residual diverges ({variant})",
    )


def test_ip_adapter_resampler_matches_torch_mirror(rng):
    """IP-Adapter-Plus perceiver resampler anchor: output allclose vs the
    independent MirrorResampler through the real image_proj converter +
    shape-inferred config (dim_head is the h94-fixed 64)."""
    from stablediffusion_tpu.models.ip_adapter import (
        convert_image_proj,
        infer_image_proj_config,
        resampler_apply,
    )
    from torch_mirror import MirrorResampler

    torch.manual_seed(3)
    mirror = MirrorResampler(
        dim=32, depth=2, dim_head=64, heads=1, num_queries=4,
        embedding_dim=24, output_dim=16,
    ).eval()
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    cfg = infer_image_proj_config(sd)
    assert cfg.kind == "resampler" and cfg.depth == 2 and cfg.heads == 1
    params = convert_image_proj(sd)

    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    ours = resampler_apply(params, cfg, jnp.asarray(x))
    with torch.no_grad():
        theirs = mirror(torch.from_numpy(x))
    np.testing.assert_allclose(
        np.asarray(ours), theirs.numpy(), atol=2e-4, rtol=2e-4,
        err_msg="IP-Adapter-Plus resampler diverges from torch mirror",
    )
