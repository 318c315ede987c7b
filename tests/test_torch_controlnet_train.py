"""PyTorch/CUDA port: ControlNet training against the JAX package, in fp32
on the CPU with the tiny SD1.5 and SDXL models.

A fresh ControlNet (``init_from_unet``, as the trainer builds it) leaves
the UNet's output unchanged, exactly; ``controlnet_loss_fn``'s loss and
its gradient to every ControlNet weight against
``jax.value_and_grad(controlnet_loss_fn)`` with the JAX draws injected
(SD1.5 and SDXL), within TOL of max(1, max |ref|); two steps of the whole
trainer against the JAX ``ControlNetTrainer`` from the same ControlNet
folder, data and seed (the JAX loop keys' draws handed in through
``draws=``), within REL_TOL of each weight's largest value (Adam's eps at
the tiny gradients' scale, as the full fine-tuning test sets it); a resume
equal to the straight run; the saved folder read back equal by both
packages' loaders; the CLI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stablediffusion_tpu.core.rng import as_key
from stablediffusion_tpu.schedulers import DDPMScheduler as JDDPM
from stablediffusion_tpu.train import train_step as jts
from stablediffusion_tpu.train.controlnet_trainer import ControlNetTrainer as JTrainer
from stablediffusion_tpu.train.controlnet_trainer import ControlNetTrainingArgs as JArgs
from stablediffusion_tpu_torch.io.from_jax import flatten, to_torch_layout
from stablediffusion_tpu_torch.io.loader import load_controlnet, save_sd_model
from stablediffusion_tpu_torch.schedulers import DDPMScheduler
from stablediffusion_tpu_torch.train import controlnet_cli
from stablediffusion_tpu_torch.train import train_step as tts
from stablediffusion_tpu_torch.train.controlnet_trainer import (
    ControlNetTrainer,
    ControlNetTrainingArgs,
)
from stablediffusion_tpu_torch.utils.testing import write_controlnet_folder, write_image_folder
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

TOL = 1e-4
REL_TOL = 1e-4
STEPS, BATCH, RES, SEED = 2, 2, 32, 4


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, float(np.abs(ref).max())), f"{what}: {err}"


def _rel(got, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


def _torch_named(tree):
    return {k: to_torch_layout(k, np.asarray(a)) for k, a in flatten(tree).items()}


def _draws(key, tm, B=BATCH, res=RES):
    """The JAX step's draws for `key` (train_step.py:157-190), NCHW."""
    k_sample, k_noise, k_t, _ = jax.random.split(key, 4)
    h = res // tm.vae_scale_factor
    shape = (B, h, h, tm.vae_config.latent_channels)
    nchw = lambda a: torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))  # noqa: E731
    return {"latent_eps": nchw(jax.random.normal(k_sample, shape, jnp.float32)),
            "noise": nchw(jax.random.normal(k_noise, shape, jnp.float32)),
            "timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, 1000)))}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A folder of four captioned images and a folder of control images
    under the same names."""
    root = tmp_path_factory.mktemp("cn_data")
    img = write_image_folder(str(root / "img"), 4, (40, 48), seed=0)
    cond = root / "cond"
    cond.mkdir()
    rng = np.random.default_rng(1)
    for f in sorted(os.listdir(img)):
        if f.endswith(".jpg"):
            edges = (rng.uniform(0, 1, (40, 48)) > 0.8).astype(np.uint8) * 255
            Image.fromarray(np.stack([edges] * 3, -1)).save(cond / f.replace(".jpg", ".png"))
    return img, str(cond)


@pytest.fixture(scope="module")
def cn_folders(tmp_path_factory):
    """{family: (port model, ControlNet folder)}: a seeded ControlNet in
    fp32 (its zero convolutions non-zero, so gradients reach every weight)."""
    out = {}
    for family, tm in (("sd15", tiny_port_model(seed=3)), ("sdxl", tiny_sdxl_port_model(seed=5))):
        folder = str(tmp_path_factory.mktemp(f"cn_{family}"))
        write_controlnet_folder(folder, tm.unet_config, device="cpu", dtype=torch.float32,
                                seed=6)
        out[family] = (tm, folder)
    return out


def test_fresh_controlnet_leaves_the_unet_unchanged():
    """The trainer's fresh ControlNet (init_from_unet): zero residuals, so
    the UNet's output with them is its output without, bit for bit."""
    tm = tiny_port_model(seed=2)
    args = ControlNetTrainingArgs(report_to=None)
    trainer = ControlNetTrainer(tm, args, dataset=object())
    cfg, net, masters = trainer._init_controlnet(torch.Generator().manual_seed(0))
    assert set(masters) == set(dict(net.named_parameters()))
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy(r.standard_normal((2, 77, 32)).astype(np.float32))
    cond = torch.from_numpy(r.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    t = torch.tensor([10, 900])
    with torch.no_grad():
        down, mid = net(x, t, ctx, cond)
        assert all(not d.any() for d in down) and not mid.any()
        assert torch.equal(tm.unet(x, t, ctx, down_block_residuals=down, mid_block_residual=mid),
                           tm.unet(x, t, ctx))


def _batch(tm, sdxl, B=BATCH, res=RES):
    r = np.random.default_rng(7)
    b = {"pixel_values": r.uniform(-1, 1, (B, res, res, 3)).astype(np.float32),
         "conditioning_pixel_values": r.uniform(0, 1, (B, res, res, 3)).astype(np.float32),
         "input_ids": np.asarray(tm.tokenizer(["a cat", "a red dog"])).astype(np.int32)}
    if sdxl:
        b["input_ids_2"] = np.asarray(tm.tokenizer_2(["a cat", "a red dog"])).astype(np.int32)
        b["original_sizes"] = np.full((B, 2), float(res), np.float32)
        b["crop_top_lefts"] = np.zeros((B, 2), np.float32)
        b["target_sizes"] = np.full((B, 2), float(res), np.float32)
    return b


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_loss_and_controlnet_grads_match_jax(cn_folders, family):
    """The loss and the gradient of every ControlNet weight against
    jax.value_and_grad(controlnet_loss_fn), the draws injected."""
    tm, folder = cn_folders[family]
    sdxl = family == "sdxl"
    jm = to_jax_model(tm)
    jm.load_controlnet(folder)
    kw = dict(train_text_encoder=False, snr_gamma=5.0)
    jst = jts.TrainStatics(
        unet_config=jm.unet_config, vae_config=jm.vae_config,
        text_config=jm.text_encoder_config,
        text_config_2=jm.text_encoder_2_config if sdxl else None,
        scheduler_config=jm.scheduler_config, compute_dtype=jnp.float32,
        controlnet_config=jm.controlnet_config, **kw)
    cfg, net = load_controlnet(folder, torch.device("cpu"), torch.float32)
    tst = tts.TrainStatics(
        unet_config=tm.unet_config, vae_config=tm.vae_config,
        text_config=tm.text_encoder_config,
        text_config_2=tm.text_encoder_2_config if sdxl else None,
        scheduler_config=tm.scheduler_config, compute_dtype=torch.float32,
        controlnet_config=cfg, **kw)
    batch = _batch(tm, sdxl)
    key = jax.random.key(9)
    frozen_j = {"unet": jm.unet_params, "vae": jm.vae_params,
                "text_encoder": jm.text_encoder_params}
    frozen_t = {"unet": tm.unet, "vae": tm.vae, "text_encoder": tm.text_encoder,
                "controlnet": net.requires_grad_(False)}
    if sdxl:
        frozen_j["text_encoder_2"] = jm.text_encoder_2_params
        frozen_t["text_encoder_2"] = tm.text_encoder_2
    loss_ref, g_ref = jax.jit(jax.value_and_grad(jts.controlnet_loss_fn),
                              static_argnums=(4, 5))(
        jm.controlnet_params, frozen_j, jax.tree_util.tree_map(jnp.asarray, batch), key, jst,
        JDDPM(jst.scheduler_config))
    masters = {n: p.detach().clone().requires_grad_(True) for n, p in net.named_parameters()}
    loss = tts.controlnet_loss_fn(
        masters, frozen_t, {k: torch.from_numpy(v) for k, v in batch.items()}, None, tst,
        DDPMScheduler(tst.scheduler_config), draws=_draws(key, tm))
    grads = dict(zip(masters, torch.autograd.grad(loss, list(masters.values()))))
    _close(loss.item(), float(loss_ref), "loss")
    ref = _torch_named(jax.tree_util.tree_map(np.asarray, g_ref))
    assert sorted(ref) == sorted(grads)
    moved = 0
    for n, g in grads.items():
        _close(g.numpy(), ref[n], n)
        moved += bool(np.abs(ref[n]).max() > 0)
    assert moved > 0.9 * len(grads)


def test_control_image_resize_equals_jax():
    """A conditioning batch at another size than latent x 8 is resized as
    jax.image.resize(..., "bilinear") resizes it, down and up."""
    r = np.random.default_rng(3)
    cond = r.uniform(0, 1, (2, 40, 48, 3)).astype(np.float32)
    for hw in ((4, 4), (8, 8), (5, 6)):
        ref = jax.image.resize(jnp.asarray(cond), (2, hw[0] * 8, hw[1] * 8, 3), "bilinear")
        out = tts.control_image_for(torch.from_numpy(cond), hw).permute(0, 2, 3, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _args(mod, out, **kw):
    base = dict(train_batch_size=BATCH, resolution=RES, max_train_steps=STEPS,
                learning_rate=1e-3, lr_scheduler="constant", lr_warmup_steps=0,
                mixed_precision="no", adam_epsilon=1e-2, seed=SEED, output_dir=str(out),
                log_every=1, report_to=None)
    base.update(kw)
    return mod(**base)


def _jax_step_draws(tm, steps=STEPS):
    """The draws of the JAX trainer's loop keys (controlnet_trainer.py:113,
    :213), for the port's ``draws=``."""
    _, k_loop = jax.random.split(as_key(SEED))
    out = []
    for _ in range(steps):
        k_loop, k_step = jax.random.split(k_loop)
        out.append(_draws(k_step, tm))
    return out


@pytest.fixture(scope="module")
def trained(cn_folders, data, tmp_path_factory):
    """Two steps of the JAX trainer and the port's, from the same ControlNet
    folder, folder pair and seed."""
    tm, folder = cn_folders["sd15"]
    img, cond = data
    out = tmp_path_factory.mktemp("cn_train")
    jm = to_jax_model(tm)
    jt = JTrainer(jm, _args(JArgs, out / "jax"), img, cond, controlnet_path=folder)
    jnet = _torch_named(jax.tree_util.tree_map(np.asarray, jt.train()))
    draws = _jax_step_draws(tm)
    pt = ControlNetTrainer(tm, _args(ControlNetTrainingArgs, out / "port",
                                     checkpointing_steps=1),
                           img, cond, controlnet_path=folder, draws=lambda s: draws[s])
    pnet = pt.train()
    return jt, jnet, pt, pnet, out, draws


def test_trainer_matches_jax(trained):
    """Logged losses and every ControlNet weight after two steps."""
    jt, jnet, pt, pnet, _, _ = trained
    assert [s for s, _ in pt.history] == [s for s, _ in jt.history] == [1, 2]
    for (_, a), (_, b) in zip(pt.history, jt.history):
        _rel(a, b, "loss")
    assert sorted(pnet) == sorted(jnet)
    for n, t in pnet.items():
        _rel(t.numpy(), jnet[n], n)


def test_saved_folder_reloads_equal(trained):
    """The final folder holds the fp32 masters: the port's loader and the
    JAX package's read them back equal."""
    _, _, pt, pnet, out, _ = trained
    folder = str(out / "port")
    _, net = load_controlnet(folder, torch.device("cpu"), torch.float32)
    for n, p in net.named_parameters():
        assert torch.equal(p, pnet[n]), n
    jm = to_jax_model(pt.model)
    jm.load_controlnet(folder)
    jparams = _torch_named(jax.tree_util.tree_map(np.asarray, jm.controlnet_params))
    assert sorted(jparams) == sorted(pnet)
    for n, a in jparams.items():
        np.testing.assert_array_equal(a, pnet[n].numpy())


def test_resume_equals_straight_run(trained, cn_folders, data):
    """A run resumed from the checkpoint of step 1 ends where the straight
    run ended, bit for bit."""
    _, _, _, pnet, out, draws = trained
    tm, folder = cn_folders["sd15"]
    img, cond = data
    resumed = ControlNetTrainer(
        tm, _args(ControlNetTrainingArgs, out / "port", resume_from_checkpoint=str(
            out / "port" / "checkpoint-1")),
        img, cond, controlnet_path=folder, draws=lambda s: draws[s]).train()
    for n, t in resumed.items():
        assert torch.equal(t, pnet[n]), n


def test_cli_trains_and_saves(cn_folders, data, tmp_path):
    """The CLI's folder-pair path on a saved tiny model: one step, the
    ControlNet folder written; a missing conditioning folder refused."""
    tm, _ = cn_folders["sd15"]
    img, cond = data
    model_dir = str(tmp_path / "model")
    save_sd_model(tm, model_dir)
    out = str(tmp_path / "out")
    trainer = controlnet_cli.main([
        "--pretrained_model_name_or_path", model_dir, "--train_data_dir", img,
        "--conditioning_data_dir", cond, "--output_dir", out, "--resolution", str(RES),
        "--train_batch_size", "2", "--max_train_steps", "1", "--mixed_precision", "no",
        "--report_to", "none", "--device", "cpu", "--scale_lr", "--use_8bit_adam"])
    assert trainer.args.learning_rate == pytest.approx(5e-6 * 2)  # accumulation x batch x 1
    assert os.path.exists(os.path.join(out, "config.json"))
    assert [s for s, _ in trainer.history] == [1]
    with pytest.raises(SystemExit):
        controlnet_cli.parse_args(["--pretrained_model_name_or_path", model_dir,
                                   "--train_data_dir", img])


def test_args_defaults_match_jax():
    """Every field and default of the JAX package's ControlNetTrainingArgs."""
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(JArgs)}
    tf = {f.name: f.default for f in dataclasses.fields(ControlNetTrainingArgs)}
    for name, default in jf.items():
        assert tf[name] == default, name
