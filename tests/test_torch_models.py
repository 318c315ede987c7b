"""PyTorch/CUDA port: CLIP, UNet and VAE decode against clip.apply,
unet.apply and vae.decode on the tiny configs, in fp32 on the CPU.

Weights are JAX-initialised and carried into the port's modules by
io/from_jax.py; inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.models import clip as jclip
from stablediffusion_tpu.models import unet as junet
from stablediffusion_tpu.models import vae as jvae
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.io.from_jax import load_from_jax
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import UNPORTED_PREFIXES, AutoencoderKL

# fp32 on both sides through a few layers of GEMMs/convs and norms: only the
# order of the sums differs; 1e-4 absolute on O(1) outputs
ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, cfg, seed=0):
    """JAX init under jit: eager init of even the tiny UNet takes ~16 s."""
    init = jax.jit(module.init_params, static_argnums=1)
    return _np_tree(init(jax.random.key(seed), cfg))


@pytest.mark.parametrize("with_projection", [False, True])
def test_clip_matches_jax(with_projection):
    jc = jcfg.tiny_clip_config(with_projection=with_projection)
    params = _init(jclip, jc)
    model = load_from_jax(CLIPTextModel(tcfg.tiny_clip_config(with_projection)), params)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 990, (2, 77)).astype(np.int32)
    ids[0, 9] = ids[1, 30] = jc.eos_token_id
    ids[1, 50] = jc.eos_token_id  # pooled takes the FIRST eos
    ref = jclip.apply(params, jc, jnp.asarray(ids))  # returns a non-pytree dataclass
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
    np.testing.assert_allclose(out.last_hidden_state.numpy(), np.asarray(ref.last_hidden_state), atol=ATOL)
    np.testing.assert_allclose(out.pooled_output.numpy(), np.asarray(ref.pooled_output), atol=ATOL)
    assert len(out.hidden_states) == len(ref.hidden_states) == jc.num_hidden_layers + 1
    for a, b in zip(out.hidden_states, ref.hidden_states):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    skip = jclip.final_layer_norm(params, jc, ref.hidden_states[-2])
    np.testing.assert_allclose(
        model.final_layer_norm(out.hidden_states[-2]).detach().numpy(), np.asarray(skip), atol=ATOL
    )
    if with_projection:
        np.testing.assert_allclose(out.projected_pooled.numpy(), np.asarray(ref.projected_pooled), atol=ATOL)
    else:
        assert out.projected_pooled is None


def test_unet_matches_jax():
    jc = jcfg.tiny_unet_config()
    params = _init(junet, jc)
    model = load_from_jax(UNet2DConditionModel(tcfg.tiny_unet_config()), params)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    for t in (np.int32(981), np.array([1, 500], np.int32)):
        ref = jax.jit(junet.apply, static_argnums=1)(
            params, jc, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        with torch.no_grad():
            out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(np.asarray(t)),
                        torch.from_numpy(ctx))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=ATOL)


def test_unet_state_dict_keys_are_the_jax_tree_keys():
    """Module names reproduce the diffusers keys that the JAX tree uses."""
    from stablediffusion_tpu_torch.io.from_jax import flatten

    cfg = tcfg.SD15_UNET
    shapes = jax.eval_shape(lambda k: junet.init_params(k, jcfg.SD15_UNET), jax.random.key(0))
    with torch.device("meta"):
        model = UNet2DConditionModel(cfg)
    jkeys = set(flatten(jax.tree_util.tree_map(lambda s: np.zeros(()), shapes)))
    assert set(model.state_dict()) == jkeys
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)
    )


def test_unet_rejects_unported_config():
    import dataclasses

    with pytest.raises(NotImplementedError):
        UNet2DConditionModel(dataclasses.replace(tcfg.tiny_unet_config(), use_linear_projection=True))


def test_vae_decode_matches_jax():
    jc = jcfg.tiny_vae_config()
    params = _init(jvae, jc)
    model = load_from_jax(AutoencoderKL(tcfg.tiny_vae_config()), params,
                          skip_prefixes=UNPORTED_PREFIXES)
    z = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = jax.jit(jvae.decode, static_argnums=1)(params, jc, jnp.asarray(z))
    with torch.no_grad():
        out = model.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    assert out.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=ATOL)


def test_from_jax_is_strict():
    jc = jcfg.tiny_vae_config()
    params = _init(jvae, jc)
    model = AutoencoderKL(tcfg.tiny_vae_config())
    with pytest.raises(KeyError, match="unexpected"):  # encoder keys not skipped
        load_from_jax(model, params)
    trimmed = {k: v for k, v in params.items() if k != "post_quant_conv"}
    with pytest.raises(KeyError, match="missing"):
        load_from_jax(model, trimmed, skip_prefixes=UNPORTED_PREFIXES)


def test_from_jax_layouts():
    """HWIO -> OIHW, (in, out) -> (out, in), embedding tables and
    time_embedding linears by the exact-suffix rule."""
    from stablediffusion_tpu_torch.io.from_jax import to_torch_layout

    a = np.zeros((3, 3, 4, 8))
    assert to_torch_layout("conv_in.weight", a).shape == (8, 4, 3, 3)
    assert to_torch_layout("to_q.weight", np.zeros((4, 8))).shape == (8, 4)
    assert to_torch_layout("time_embedding.linear_1.weight", np.zeros((4, 8))).shape == (8, 4)
    emb = "text_model.embeddings.token_embedding.weight"
    assert to_torch_layout(emb, np.zeros((10, 4))).shape == (10, 4)
    assert to_torch_layout("conv_in.bias", np.zeros((8,))).shape == (8,)
