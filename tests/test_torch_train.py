"""PyTorch/CUDA port: the SD1.5 LoRA training slice against the JAX package,
in fp32 on the CPU with the tiny configs.

DDPM's add_noise / get_velocity / step, the LoRA runtime and the JAX tree
bridge, the LR schedules and clip + AdamW against optax, and the slice as a
whole: ``loss_fn`` and its LoRA gradients against
``jax.value_and_grad(loss_fn)``, then three steps of ``make_train_step``
holding the factors after each.  ``jax.random`` cannot be reproduced in
torch, so the JAX step's draws are made from its key the way
``_prepare_diffusion`` makes them (train_step.py:157) and injected into the
port through ``draws=`` (NHWC -> NCHW).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.lora import core as jlora
from stablediffusion_tpu.models import clip as jclip
from stablediffusion_tpu.models import unet as junet
from stablediffusion_tpu.models import vae as jvae
from stablediffusion_tpu.schedulers import DDPMScheduler as JDDPM
from stablediffusion_tpu.train import optim as joptim
from stablediffusion_tpu.train import train_step as jts
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.io.from_jax import load_from_jax, lora_from_jax
from stablediffusion_tpu_torch.lora import core as tlora
from stablediffusion_tpu_torch.models.clip import CLIPTextModel
from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
from stablediffusion_tpu_torch.models.vae import AutoencoderKL
from stablediffusion_tpu_torch.schedulers import DDPMScheduler, make_scheduler
from stablediffusion_tpu_torch.train import optim as toptim
from stablediffusion_tpu_torch.train import train_step as tts


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(np.transpose(np.asarray(a), (0, 3, 1, 2)))


# -- (c) DDPM ----------------------------------------------------------------


@pytest.mark.parametrize("ptype", ["epsilon", "v_prediction"])
def test_ddpm_matches_jax(ptype):
    """fp32 on both sides with the same fp32 tables: 1e-6 on O(1) values."""
    cfg = dataclasses.replace(jcfg.SchedulerConfig(), prediction_type=ptype)
    js, ts = JDDPM(cfg), make_scheduler("DDPM", tcfg.SchedulerConfig(prediction_type=ptype))
    assert isinstance(ts, DDPMScheduler)
    r = np.random.default_rng(0)
    x0 = r.standard_normal((3, 8, 8, 4)).astype(np.float32)
    noise = r.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = np.array([0, 499, 999], np.int32)
    for name in ("add_noise", "get_velocity"):
        ref = getattr(js, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        out = getattr(ts, name)(_nchw(x0), _nchw(noise), _t(t))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-6)
    jplan, tplan = js.plan(20), ts.plan(20)
    np.testing.assert_array_equal(np.asarray(jplan.timesteps), tplan.timesteps)
    key = jax.random.key(3)
    step_noise = np.array(jax.random.normal(key, x0.shape, jnp.float32))
    for i in (0, 7, 19):  # the last step is t = 1; t > 0 adds noise
        ref, _ = js.step(jplan, (), i, jnp.asarray(noise), jnp.asarray(x0), key=key)
        out = ts.step(tplan, i, _nchw(noise), _nchw(x0), noise=_nchw(step_noise))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError, match="noise"):
        ts.step(tplan, 0, _nchw(noise), _nchw(x0))


# -- (d) LoRA ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_unet():
    params = _np(jax.jit(junet.init_params, static_argnums=1)(
        jax.random.key(0), jcfg.tiny_unet_config()))
    return params, load_from_jax(UNet2DConditionModel(tcfg.tiny_unet_config()), params)


def test_lora_matches_jax(tiny_unet):
    params, unet = tiny_unet
    jl = _np(jlora.init_lora(jax.random.key(1), params, 2, jlora.UNET_TARGET_SUFFIXES))
    tl = tlora.init_lora(unet, 2, tlora.UNET_TARGET_SUFFIXES, torch.Generator().manual_seed(1))
    assert tlora.linear_module_paths(unet, tlora.UNET_TARGET_SUFFIXES) == sorted(jl)
    assert list(tl) == sorted(jl)
    for path in jl:
        assert {k: tuple(v.shape) for k, v in tl[path].items()} == \
            {k: v.shape for k, v in jl[path].items()}
        assert not tl[path]["up"].any()
    assert tlora.num_lora_params(tl) == jlora.num_lora_params(jl)

    # non-zero factors, carried across and back unchanged
    r = np.random.default_rng(2)
    for f in jl.values():
        f["up"] = r.standard_normal(f["up"].shape).astype(np.float32) * 0.1
        f["alpha"] = np.float32(3.0)
    carried = lora_from_jax(jl)
    for path, f in jl.items():
        for name, a in f.items():
            np.testing.assert_array_equal(carried[path][name].numpy(), a)
    path = sorted(jl)[0]
    np.testing.assert_allclose(tlora.delta_w(carried[path], 0.5).numpy(),
                               np.asarray(jlora.delta_w(jl[path], 0.5)), atol=1e-6)

    # fuse at two adapter weights against jax fuse, in the (out, in) layout
    second = {p: dict(f, up=f["up"] * -2.0) for p, f in jl.items()}
    weights = {"a": 0.7, "b": 0.25}
    jf = jlora.fuse(params, {"a": jl, "b": second}, weights)
    tf = tlora.fuse(unet, {"a": carried, "b": lora_from_jax(second)}, weights)
    assert sorted(tf) == sorted(f"{p}.weight" for p in jl)
    for p in jl:
        ref = jlora._get_path(jf, p)["weight"]
        np.testing.assert_allclose(tf[f"{p}.weight"].numpy().T, np.asarray(ref), atol=1e-6)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    tr = tlora.apply_lora_for_training(unet, {p: {k: v for k, v in f.items() if k != "alpha"}
                                              for p, f in carried.items()})
    assert all(torch.equal(v, unet.state_dict()[k]) for k, v in before.items())
    jt = jlora.apply_lora_for_training(params, {p: {k: v for k, v in f.items() if k != "alpha"}
                                                for p, f in jl.items()})
    np.testing.assert_allclose(tr[f"{path}.weight"].detach().numpy().T,
                               np.asarray(jlora._get_path(jt, path)["weight"]), atol=1e-6)
    with pytest.raises(ValueError, match="matched no module"):
        tlora.fuse(unet, {"x": {"no.such.module": carried[path]}})
    with pytest.raises(KeyError):
        lora_from_jax({"a": {"down": np.zeros((2, 2))}})


# -- (e) optimizer -----------------------------------------------------------


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_restarts", "polynomial"])
def test_lr_schedule_matches_optax(name):
    kw = dict(warmup_steps=5, total_steps=40, num_cycles=3, power=2.0)
    js = joptim.make_lr_schedule(name, 3e-4, **kw)
    ts = toptim.make_lr_schedule(name, 3e-4, **kw)
    counts = np.arange(0, 50)
    ref = np.array([float(js(jnp.asarray(c, jnp.int32))) for c in counts])
    out = np.array([ts(int(c)) for c in counts])
    # optax evaluates in fp32, the port in fp64: 1e-6 of the peak rate (fp32
    # cos near pi loses relative precision where the rate nears zero)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * 3e-4)


def test_clip_adamw_matches_optax():
    """Five steps of clip_by_global_norm + adamw (decay masked to ndim >= 2)
    on a LoRA-shaped tree with a scalar leaf; the threshold sits inside the
    spread of the gradient norms so that some steps clip and some do not."""
    r = np.random.default_rng(0)
    params = {"m": {"down": r.standard_normal((6, 2)).astype(np.float32),
                    "up": r.standard_normal((2, 5)).astype(np.float32),
                    "alpha": np.array(2.0, np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p, s=s: np.asarray(r.standard_normal(np.shape(p)) * s, np.float32), params)
        for s in (0.2, 3.0, 0.1, 2.0, 0.3)]
    norms = [float(optax.global_norm(g)) for g in grads]
    max_norm = 1.5
    assert min(norms) < max_norm < max(norms)
    sched = dict(name="linear", lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = joptim.make_optimizer(joptim.make_lr_schedule(**sched), max_grad_norm=max_norm)
    topt = toptim.make_optimizer(toptim.make_lr_schedule(**sched), max_grad_norm=max_norm)
    jp, js = params, jopt.init(params)
    tp = jax.tree_util.tree_map(lambda a: _t(a), params)
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(jax.tree_util.tree_map(lambda a: _t(a), g), ts, tp)
        for k in ("down", "up", "alpha"):
            np.testing.assert_allclose(tp["m"][k].numpy(), np.asarray(jp["m"][k]), atol=1e-6)
    with pytest.raises(NotImplementedError, match="8-bit"):
        toptim.make_optimizer(toptim.make_lr_schedule("constant", 1e-4), use_8bit=True)
    with pytest.raises(NotImplementedError, match="accumulation"):
        toptim.make_optimizer(toptim.make_lr_schedule("constant", 1e-4), grad_accum_steps=2)


# -- (f) the slice as a whole ------------------------------------------------

# fp32 through VAE encode, CLIP, the UNet forward and its backward on both
# sides: only the order of the sums differs.  Held relative to each tensor's
# largest element.
REL_TOL = 1e-4


def _close(out, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


@pytest.fixture(scope="module")
def tiny_sd():
    """JAX params and the port's modules of a tiny SD1.5-layout model, a
    LoRA with non-zero `up` factors (zeros would give zero `down`
    gradients), and a batch."""
    keys = jax.random.split(jax.random.key(0), 4)
    ucfg, vcfg, ccfg = jcfg.tiny_unet_config(), jcfg.tiny_vae_config(), jcfg.tiny_clip_config()
    jit_init = lambda m, k, c: _np(jax.jit(m.init_params, static_argnums=1)(k, c))  # noqa: E731
    frozen = {"unet": jit_init(junet, keys[0], ucfg), "vae": jit_init(jvae, keys[1], vcfg),
              "text_encoder": jit_init(jclip, keys[2], ccfg)}
    lora = _np(jlora.init_lora(keys[3], frozen["unet"], 2, jlora.UNET_TARGET_SUFFIXES,
                               store_alpha=False))
    r = np.random.default_rng(5)
    for f in lora.values():
        f["up"] = (r.standard_normal(f["up"].shape) * 0.1).astype(np.float32)
    batch = {"pixel_values": r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             "input_ids": r.integers(0, 999, (2, 77)).astype(np.int32)}
    port = {
        "unet": load_from_jax(UNet2DConditionModel(tcfg.tiny_unet_config()), frozen["unet"]),
        "vae": load_from_jax(AutoencoderKL(tcfg.tiny_vae_config()), frozen["vae"]),
        "text_encoder": load_from_jax(CLIPTextModel(tcfg.tiny_clip_config()),
                                      frozen["text_encoder"]),
    }
    for m in port.values():
        m.requires_grad_(False)
    return frozen, lora, batch, port


def _statics(mod, cfg_mod, dtype, **kw):
    return mod.TrainStatics(
        unet_config=cfg_mod.tiny_unet_config(), vae_config=cfg_mod.tiny_vae_config(),
        text_config=cfg_mod.tiny_clip_config(), text_config_2=None,
        scheduler_config=cfg_mod.SchedulerConfig(**kw.pop("sched", {})),
        train_text_encoder=False, snr_gamma=5.0, compute_dtype=dtype, **kw)


def _draws(key, frozen, batch, vcfg, noise_offset):
    """The JAX step's draws for `key` (train_step.py:157-210), NCHW."""
    k_sample, k_noise, k_t, k_offset = jax.random.split(key, 4)
    mean, _ = jvae.encode(frozen["vae"], vcfg, jnp.asarray(batch["pixel_values"]))
    B = mean.shape[0]
    draws = {
        "latent_eps": _nchw(jax.random.normal(k_sample, mean.shape, mean.dtype)),
        "noise": _nchw(jax.random.normal(k_noise, mean.shape, jnp.float32)),
        "timesteps": _t(jax.random.randint(k_t, (B,), 0, 1000)),
    }
    if noise_offset:
        draws["offset"] = _nchw(jax.random.normal(k_offset, (B, 1, 1, mean.shape[-1]),
                                                  jnp.float32))
    return draws


@pytest.mark.parametrize("ptype, noise_offset", [("epsilon", 0.0), ("v_prediction", 0.1)])
def test_loss_and_lora_grads_match_jax(tiny_sd, ptype, noise_offset):
    frozen, lora, batch, port = tiny_sd
    kw = dict(sched={"prediction_type": ptype}, noise_offset=noise_offset)
    jst = _statics(jts, jcfg, jnp.float32, **dict(kw, sched=dict(kw["sched"])))
    tst = _statics(tts, tcfg, torch.float32, **kw)
    jsched, tsched = JDDPM(jst.scheduler_config), DDPMScheduler(tst.scheduler_config)
    key = jax.random.key(7)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(jts.loss_fn), static_argnums=(4, 5))(
        {"unet": lora}, frozen, jbatch, key, jst, jsched)
    draws = _draws(key, frozen, batch, jst.vae_config, noise_offset)
    trainable = {"unet": lora_from_jax(lora)}
    leaves = [t.requires_grad_(True) for _, t in toptim.tree_leaves(trainable)]
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss = tts.loss_fn(trainable, port, tbatch, None, tst, tsched, draws=draws)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), float(loss_ref), "loss")
    flat_ref = dict(toptim.tree_leaves(_np(g_ref)))
    for (path, _), g in zip(toptim.tree_leaves(trainable), grads):
        assert np.abs(flat_ref[path]).max() > 0, path
        _close(g.numpy(), flat_ref[path], path)


def test_train_steps_match_jax(tiny_sd):
    """Three steps of make_train_step with clip + AdamW + a warmup schedule
    on both sides; loss, grad norm and every factor after each step."""
    frozen, lora, batch, port = tiny_sd
    jst = _statics(jts, jcfg, jnp.float32)
    tst = _statics(tts, tcfg, torch.float32)
    sched = dict(name="constant_with_warmup", lr=1e-4, warmup_steps=2)
    jopt = joptim.make_optimizer(joptim.make_lr_schedule(**sched), max_grad_norm=1e-3)
    topt = toptim.make_optimizer(toptim.make_lr_schedule(**sched), max_grad_norm=1e-3)
    jstep = jts.make_train_step(jst, JDDPM(jst.scheduler_config), jopt)
    tstep = tts.make_train_step(tst, DDPMScheduler(tst.scheduler_config), topt)
    jtrain = {"unet": jax.tree_util.tree_map(jnp.asarray, lora)}
    jopt_state = jopt.init(jtrain)
    ttrain = {"unet": lora_from_jax(lora)}
    topt_state = topt.init(ttrain)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for i in range(3):
        key = jax.random.key(10 + i)
        jtrain, jopt_state, jm = jstep(jtrain, jopt_state, frozen, jbatch, key)
        draws = _draws(key, frozen, batch, jst.vae_config, 0.0)
        ttrain, topt_state, tm = tstep(ttrain, topt_state, port, tbatch, None, draws=draws)
        _close(tm["loss"].item(), float(jm["loss"]), f"step {i} loss")
        _close(tm["grad_norm"].item(), float(jm["grad_norm"]), f"step {i} grad norm")
        assert float(jm["grad_norm"]) > 1e-3  # the clip acts
        flat_ref = dict(toptim.tree_leaves(_np(jtrain)))
        for path, t in toptim.tree_leaves(ttrain):
            assert not t.requires_grad
            _close(t.numpy(), flat_ref[path], f"step {i} {path}")


def test_unported_training_settings_raise():
    base = _statics(tts, tcfg, torch.float32)
    for kw, match in ((dict(text_config_2=tcfg.tiny_clip_config()), "SDXL"),
                      (dict(train_text_encoder=True), "train_text_encoder"),
                      (dict(ti_rows=(1,)), "textual-inversion"),
                      (dict(controlnet_config=tcfg.tiny_unet_config()), "ControlNet"),
                      (dict(remat_policy="dots"), "dots"),
                      (dict(remat_policy="offload"), "offload")):
        with pytest.raises(NotImplementedError, match=match):
            tts.make_train_step(dataclasses.replace(base, **kw), DDPMScheduler(), None)
    with pytest.raises(ValueError, match="remat_policy"):
        tts.check_supported(dataclasses.replace(base, remat_policy="sometimes"))


def test_precomputed_batch_keys_and_vae_microbatch(tiny_sd):
    """The batch keys "latents" and "prompt_embeds" (encoded elsewhere) and
    an encode in microbatches give the loss of the plain batch, with the
    same draws."""
    frozen, lora, batch, port = tiny_sd
    tbatch = {k: _t(v) for k, v in batch.items()}
    draws = _draws(jax.random.key(4), frozen, batch, jcfg.tiny_vae_config(), 0.0)
    tst = _statics(tts, tcfg, torch.float32)
    trainable = {"unet": lora_from_jax(lora)}
    sched = DDPMScheduler()
    with torch.no_grad():
        ref = tts.loss_fn(trainable, port, tbatch, None, tst, sched, draws=draws)
        micro = tts.loss_fn(trainable, port, tbatch, None,
                            dataclasses.replace(tst, vae_microbatch=1), sched, draws=draws)
        latents, _, _, _, embeds = tts._prepare_diffusion(port, tbatch, None, tst, sched, draws)
        pre = {"latents": latents.permute(0, 2, 3, 1), "prompt_embeds": embeds}
        cached = tts.loss_fn(trainable, port, pre, None, tst, sched, draws=draws)
    torch.testing.assert_close(micro, ref, rtol=1e-6, atol=0)
    torch.testing.assert_close(cached, ref, rtol=1e-6, atol=0)


def test_remat_full_gives_the_same_gradients(tiny_sd):
    """remat_policy "full" (torch.utils.checkpoint around the UNet) changes
    what is kept for the backward, not the gradients."""
    frozen, lora, batch, port = tiny_sd
    tbatch = {k: _t(v) for k, v in batch.items()}
    draws = _draws(jax.random.key(3), frozen, batch, jcfg.tiny_vae_config(), 0.0)
    out = []
    for policy in ("none", "full"):
        tst = _statics(tts, tcfg, torch.float32, remat_policy=policy)
        trainable = {"unet": lora_from_jax(lora)}
        leaves = [t.requires_grad_(True) for _, t in toptim.tree_leaves(trainable)]
        loss = tts.loss_fn(trainable, port, tbatch, None, tst, DDPMScheduler(), draws=draws)
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
