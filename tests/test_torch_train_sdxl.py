"""PyTorch/CUDA port: the SDXL LoRA train step with text-encoder LoRA against
the JAX package, in fp32 on the CPU with the tiny SDXL model.

``loss_fn`` and its gradients to every factor (UNet, CLIP-L, bigG) against
``jax.value_and_grad(loss_fn)``, then one ``make_train_step`` step holding
the updated factors, with the text towers' LoRA on and off and under
epsilon and v-prediction.  SDXL reads CLIP-L's penultimate states only, so
the last CLIP-L layer's factors get an exactly zero gradient in both
packages.  The JAX step's draws are made from its key the way
``_prepare_diffusion`` makes them (train_step.py:157-190) and injected into
the port through ``draws=`` (NHWC -> NCHW).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.lora import core as jlora
from stablediffusion_tpu.schedulers import DDPMScheduler as JDDPM
from stablediffusion_tpu.train import optim as joptim
from stablediffusion_tpu.train import train_step as jts
from stablediffusion_tpu_torch.io.from_jax import lora_from_jax
from stablediffusion_tpu_torch.schedulers import DDPMScheduler
from stablediffusion_tpu_torch.train import optim as toptim
from stablediffusion_tpu_torch.train import train_step as tts
from torch_port_helpers import (  # noqa: F401
    _jax_cfg,
    jax_tree,
    port_test_module,
    tiny_sdxl_port_model,
)

# fp32 through the VAE encode, both towers, the UNet and their backward on
# both sides: only the order of the sums differs.  Held relative to each
# tensor's largest element.
REL_TOL = 1e-4
B, RES = 2, 32


def _close(out, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


@pytest.fixture(scope="module")
def setup():
    """The tiny SDXL model on both sides, rank-2 factors on the UNet and
    both towers with non-zero `up` (zeros would give zero `down`
    gradients), and a batch with the micro-conditioning keys."""
    tm = tiny_sdxl_port_model(seed=3)
    frozen_j = {"unet": jax_tree(tm.unet), "vae": jax_tree(tm.vae),
                "text_encoder": jax_tree(tm.text_encoder),
                "text_encoder_2": jax_tree(tm.text_encoder_2)}
    frozen_t = {"unet": tm.unet, "vae": tm.vae, "text_encoder": tm.text_encoder,
                "text_encoder_2": tm.text_encoder_2}
    keys = jax.random.split(jax.random.key(0), 3)
    r = np.random.default_rng(5)
    lora = {}
    for k, (comp, suffixes) in zip(keys, (("unet", jlora.UNET_TARGET_SUFFIXES),
                                          ("text_encoder", jlora.TEXT_TARGET_SUFFIXES),
                                          ("text_encoder_2", jlora.TEXT_TARGET_SUFFIXES))):
        tree = jax.tree_util.tree_map(np.asarray, jlora.init_lora(
            k, frozen_j[comp], 2, suffixes, store_alpha=False))
        for f in tree.values():
            f["up"] = (r.standard_normal(f["up"].shape) * 0.1).astype(np.float32)
        lora[comp] = tree
    ids = r.integers(0, 999, (2, B, 77)).astype(np.int32)
    ids[:, :, 12] = tm.text_encoder_config.eos_token_id  # pooled at the first EOS
    batch = {
        "pixel_values": r.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
        "input_ids": ids[0],
        "input_ids_2": ids[1],
        "original_sizes": np.array([[40, 48], [32, 32]], np.float32),
        "crop_top_lefts": np.array([[4, 0], [0, 0]], np.float32),
        "target_sizes": np.full((B, 2), RES, np.float32),
    }
    return tm, frozen_j, frozen_t, lora, batch


def _statics(tm, te: bool, ptype: str):
    kw = dict(train_text_encoder=te, snr_gamma=5.0, noise_offset=0.05)
    sched = dataclasses.replace(tm.scheduler_config, prediction_type=ptype)
    jst = jts.TrainStatics(
        unet_config=_jax_cfg(jcfg.UNetConfig, tm.unet_config),
        vae_config=_jax_cfg(jcfg.VAEConfig, tm.vae_config),
        text_config=_jax_cfg(jcfg.CLIPTextConfig, tm.text_encoder_config),
        text_config_2=_jax_cfg(jcfg.CLIPTextConfig, tm.text_encoder_2_config),
        scheduler_config=_jax_cfg(jcfg.SchedulerConfig, sched),
        compute_dtype=jnp.float32, **kw)
    tst = tts.TrainStatics(
        unet_config=tm.unet_config, vae_config=tm.vae_config,
        text_config=tm.text_encoder_config, text_config_2=tm.text_encoder_2_config,
        scheduler_config=sched, compute_dtype=torch.float32, **kw)
    return jst, tst


def _draws(key, tm):
    """The JAX step's draws for `key` (train_step.py:157-190), NCHW."""
    k_sample, k_noise, k_t, k_offset = jax.random.split(key, 4)
    h = RES // tm.vae_scale_factor
    shape = (B, h, h, tm.vae_config.latent_channels)
    nchw = lambda a: torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))  # noqa: E731
    return {"latent_eps": nchw(jax.random.normal(k_sample, shape, jnp.float32)),
            "noise": nchw(jax.random.normal(k_noise, shape, jnp.float32)),
            "timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, 1000))),
            "offset": nchw(jax.random.normal(k_offset, (B, 1, 1, shape[-1]), jnp.float32))}


def _trainable(lora, te):
    comps = ("unet", "text_encoder", "text_encoder_2") if te else ("unet",)
    return {c: lora[c] for c in comps}


def _last_clip_l_layer(tm):
    return f"text_model.encoder.layers.{tm.text_encoder_config.num_hidden_layers - 1}."


@pytest.mark.parametrize("te, ptype", [(True, "epsilon"), (False, "v_prediction")])
def test_sdxl_loss_and_grads_match_jax(setup, te, ptype):
    tm, frozen_j, frozen_t, lora, batch = setup
    jst, tst = _statics(tm, te, ptype)
    jsched, tsched = JDDPM(jst.scheduler_config), DDPMScheduler(tst.scheduler_config)
    key = jax.random.key(7)
    jtrain = _trainable(lora, te)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(jts.loss_fn), static_argnums=(4, 5))(
        jtrain, frozen_j, jax.tree_util.tree_map(jnp.asarray, batch), key, jst, jsched)
    trainable = {c: lora_from_jax(t) for c, t in jtrain.items()}
    leaves = [t.requires_grad_(True) for _, t in toptim.tree_leaves(trainable)]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tts.loss_fn(trainable, frozen_t, tbatch, None, tst, tsched, draws=_draws(key, tm))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    _close(loss.item(), float(loss_ref), "loss")
    flat_ref = dict(toptim.tree_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))
    assert sorted(flat_ref) == sorted(p for p, _ in toptim.tree_leaves(trainable))
    dead = "text_encoder." + _last_clip_l_layer(tm)
    n_dead = 0
    for (path, _), g in zip(toptim.tree_leaves(trainable), grads):
        if path.startswith(dead):
            # CLIP-L's last layer feeds nothing SDXL reads
            assert not g.any() and not flat_ref[path].any(), path
            n_dead += 1
            continue
        assert np.abs(flat_ref[path]).max() > 0, path
        _close(g.numpy(), flat_ref[path], path)
    assert n_dead == (8 if te else 0)  # q/k/v/out_proj, down and up


@pytest.mark.parametrize("te", [True])
def test_sdxl_train_step_matches_jax(setup, te):
    """One make_train_step step (clip + AdamW, warmup) on both sides: loss,
    grad norm, every updated factor; the dead factors stay as they were."""
    tm, frozen_j, frozen_t, lora, batch = setup
    jst, tst = _statics(tm, te, "epsilon")
    sched = dict(name="constant_with_warmup", lr=1e-3, warmup_steps=1)
    jopt = joptim.make_optimizer(joptim.make_lr_schedule(**sched), max_grad_norm=1e-2)
    topt = toptim.make_optimizer(toptim.make_lr_schedule(**sched), max_grad_norm=1e-2)
    jstep = jts.make_train_step(jst, JDDPM(jst.scheduler_config), jopt)
    tstep = tts.make_train_step(tst, DDPMScheduler(tst.scheduler_config), topt)
    jtrain = jax.tree_util.tree_map(jnp.asarray, _trainable(lora, te))
    jstate = jopt.init(jtrain)
    ttrain = {c: lora_from_jax(t) for c, t in _trainable(lora, te).items()}
    tstate = topt.init(ttrain)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    key = jax.random.key(11)
    for i in range(2):  # the warmup step moves nothing; the second does
        key, k = jax.random.split(key)
        jtrain, jstate, jm = jstep(jtrain, jstate, frozen_j,
                                   jax.tree_util.tree_map(jnp.asarray, batch), k)
        ttrain, tstate, tm_ = tstep(ttrain, tstate, frozen_t, tbatch, None,
                                    draws=_draws(k, tm))
        _close(tm_["loss"].item(), float(jm["loss"]), f"step {i} loss")
        _close(tm_["grad_norm"].item(), float(jm["grad_norm"]), f"step {i} grad norm")
    flat_ref = dict(toptim.tree_leaves(jax.tree_util.tree_map(np.asarray, jtrain)))
    dead = "text_encoder." + _last_clip_l_layer(tm)
    for path, t in toptim.tree_leaves(ttrain):
        _close(t.numpy(), flat_ref[path], path)
        if path.startswith(dead):
            assert path.endswith("up") or path.endswith("down")
            start = dict(toptim.tree_leaves(lora))[path]
            # no gradient: only the decoupled decay (masked to ndim >= 2) moves it
            np.testing.assert_allclose(t.numpy(), start * (1 - 1e-3 * 1e-2), rtol=1e-6)


def test_sdxl_encode_fn_matches_fused_prepare(setup):
    """make_encode_fn (the cache_latents program) gives the latents,
    prompt embeddings and pooled embeddings the fused path computes, and
    the same loss; under train_text_encoder it raises, as in JAX."""
    tm, _, frozen_t, lora, batch = setup
    _, tst = _statics(tm, False, "epsilon")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = _draws(jax.random.key(2), tm)
    sched = DDPMScheduler(tst.scheduler_config)
    trainable = {"unet": lora_from_jax(lora["unet"])}
    with torch.no_grad():
        cached = tts.make_encode_fn(tst)(frozen_t, tbatch, None, draws)
        assert "pixel_values" not in cached and "input_ids_2" not in cached
        latents, _, _, _, embeds, added = tts._prepare_diffusion(
            frozen_t, tbatch, None, tst, sched, draws)
        torch.testing.assert_close(cached["latents"], latents.permute(0, 2, 3, 1),
                                   rtol=0, atol=0)
        torch.testing.assert_close(cached["prompt_embeds"], embeds, rtol=0, atol=0)
        torch.testing.assert_close(cached["pooled_embeds"], added["text_embeds"],
                                   rtol=0, atol=0)
        a = tts.loss_fn(trainable, frozen_t, tbatch, None, tst, sched, draws=draws)
        b = tts.loss_fn(trainable, frozen_t, cached, None, tst, sched, draws=draws)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="train_text_encoder"):
        tts.make_encode_fn(dataclasses.replace(tst, train_text_encoder=True))


def test_remat_flags_resolve_as_jax(setup):
    """The legacy gradient_checkpointing flag means "full" under
    remat_policy "", as _resolve_remat (:122-141) resolves it, and a named
    policy wins over it; the gradients of "full", "dots" and "offload" are
    those of no remat."""
    tm, _, frozen_t, lora, batch = setup
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = _draws(jax.random.key(4), tm)
    out = []
    for kw in (dict(), dict(gradient_checkpointing=True)):
        _, tst = _statics(tm, True, "epsilon")
        tst = dataclasses.replace(tst, **kw)
        assert tts._resolve_remat(tst) == ("full" if kw else "none")
        trainable = {c: lora_from_jax(t) for c, t in lora.items()}
        leaves = [t.requires_grad_(True) for _, t in toptim.tree_leaves(trainable)]
        loss = tts.loss_fn(trainable, frozen_t, tbatch, None, tst,
                           DDPMScheduler(tst.scheduler_config), draws=draws)
        out.append(torch.autograd.grad(loss, leaves, allow_unused=True,
                                       materialize_grads=True))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    # "dots" and "offload" resolve as named and keep the gradients too
    for policy in ("dots", "offload"):
        _, tst = _statics(tm, True, "epsilon")
        tst = dataclasses.replace(tst, remat_policy=policy, gradient_checkpointing=True)
        assert tts._resolve_remat(tst) == policy
        trainable = {c: lora_from_jax(t) for c, t in lora.items()}
        leaves = [t.requires_grad_(True) for _, t in toptim.tree_leaves(trainable)]
        loss = tts.loss_fn(trainable, frozen_t, tbatch, None, tst,
                           DDPMScheduler(tst.scheduler_config), draws=draws)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        for a, b in zip(out[0], grads):
            torch.testing.assert_close(b, a, rtol=0, atol=1e-7)
    _, tst = _statics(tm, True, "epsilon")
    assert tts._resolve_remat(dataclasses.replace(tst, remat_policy="none",
                                                  gradient_checkpointing=True)) == "none"


def test_vae_dtype_casts_the_encode(setup):
    """vae_dtype bf16 on an fp32 VAE encodes with the weights cast for the
    call (JAX casts its param tree, :163-167), and leaves the module fp32."""
    import copy

    tm, _, _, _, batch = setup
    pixels = torch.from_numpy(batch["pixel_values"]).permute(0, 3, 1, 2)
    mean, logvar = tts.vae_moments(tm.vae, pixels, torch.bfloat16)
    with torch.no_grad():
        ref = copy.deepcopy(tm.vae).to(torch.bfloat16).encode(pixels.to(torch.bfloat16))
    assert mean.dtype == torch.bfloat16
    assert torch.equal(mean, ref[0]) and torch.equal(logvar, ref[1])
    assert next(tm.vae.parameters()).dtype == torch.float32
    m1, _ = tts.vae_moments(tm.vae, pixels, torch.float32, microbatch=1)
    m2, _ = tts.vae_moments(tm.vae, pixels, torch.float32)
    torch.testing.assert_close(m1, m2, rtol=1e-6, atol=1e-6)


def test_random_train_batch_has_the_sdxl_keys():
    """utils/testing.random_train_batch(sdxl=True) carries every key the
    SDXL step reads, at the layouts of the trainer's batches."""
    from stablediffusion_tpu_torch.utils.testing import random_train_batch

    b = random_train_batch(2, 64, torch.Generator().manual_seed(0), sdxl=True)
    assert b["pixel_values"].shape == (2, 64, 64, 3)
    assert b["input_ids"].shape == b["input_ids_2"].shape == (2, 77)
    for k in ("original_sizes", "crop_top_lefts", "target_sizes"):
        assert b[k].shape == (2, 2) and b[k].dtype == torch.float32
    assert b["target_sizes"].eq(64).all() and not b["crop_top_lefts"].any()
    assert "input_ids_2" not in random_train_batch(2, 64, torch.Generator().manual_seed(0))
