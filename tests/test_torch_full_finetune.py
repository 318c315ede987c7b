"""PyTorch/CUDA port: full fine-tuning with EMA against the JAX package, in
fp32 on the CPU with the tiny SD1.5 model.

``full_finetune_loss_fn`` and its gradient to every UNet weight against
``jax.value_and_grad`` (the JAX step's draws injected), then the whole
trainer: three steps with an EMA at decay 0.5 on both sides from the same
folder and seed (the JAX loop keys' draws handed to the port through
``draws=``), the logged losses, the EMA'd UNet and the saved diffusers
folder (read back by both packages' loaders) within 1e-4.  The port alone:
the EMA against an independent fp32 recomputation from the raw weights,
the 8-bit Adam, a resume equal to the straight run, and the JAX trainer's
refusals.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core.rng import as_key
from stablediffusion_tpu.io.loader import load_sd_model as jax_load_sd_model
from stablediffusion_tpu.schedulers import DDPMScheduler as JDDPM
from stablediffusion_tpu.train import train_step as jts
from stablediffusion_tpu.train.trainer import SDLoRATrainer as JTrainer
from stablediffusion_tpu.train.trainer import SDTrainingArgs as JArgs
from stablediffusion_tpu_torch.io.from_jax import flatten, to_torch_layout
from stablediffusion_tpu_torch.io.loader import load_sd_model
from stablediffusion_tpu_torch.schedulers import DDPMScheduler
from stablediffusion_tpu_torch.train import checkpoint as ckpt
from stablediffusion_tpu_torch.train import train_step as tts
from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
from stablediffusion_tpu_torch.utils.testing import write_image_folder
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_port_model,
    to_jax_model,
)

REL_TOL = 1e-4
STEPS, BATCH, RES, SEED = 3, 2, 32, 4


def _close(out, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


def _draws(key, tm):
    """The JAX step's draws for `key` (train_step.py:157-190), NCHW."""
    k_sample, k_noise, k_t, k_offset = jax.random.split(key, 4)
    h = RES // tm.vae_scale_factor
    shape = (BATCH, h, h, tm.vae_config.latent_channels)
    nchw = lambda a: torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))  # noqa: E731
    return {"latent_eps": nchw(jax.random.normal(k_sample, shape, jnp.float32)),
            "noise": nchw(jax.random.normal(k_noise, shape, jnp.float32)),
            "timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (BATCH,), 0, 1000))),
            "offset": nchw(jax.random.normal(k_offset, (BATCH, 1, 1, shape[-1]), jnp.float32))}


def _torch_named(tree):
    """A JAX param tree as {torch parameter name: array in torch layout}."""
    return {k: to_torch_layout(k, a) for k, a in flatten(tree).items()}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_image_folder(str(tmp_path_factory.mktemp("data")), 4, (40, 48), seed=0)


def _args(mod, out, **kw):
    # Adam divides each gradient element by its magnitude plus eps: at a
    # small eps an element's update is ~lr whatever its last bits, which the
    # two packages' fp32 summation orders set differently (a bias gradient
    # summed over cancelling positions keeps few of them).  With eps at the
    # tiny UNet's gradients' scale an update follows its gradient smoothly
    base = dict(train_batch_size=BATCH, resolution=RES, max_train_steps=STEPS,
                learning_rate=1e-3, lr_scheduler="constant", lr_warmup_steps=0,
                mixed_precision="no", train_text_encoder=False, full_finetune=True,
                adam_epsilon=1e-2, seed=SEED, output_dir=str(out), log_every=1,
                report_to=None)
    base.update(kw)
    return mod(**base)


def test_loss_and_unet_grads_match_jax():
    """The loss and the gradient of every UNet weight (the fp32 masters),
    against jax.value_and_grad(full_finetune_loss_fn), the draws injected."""
    tm = tiny_port_model(seed=3)
    jm = to_jax_model(tm)
    kw = dict(train_text_encoder=False, snr_gamma=5.0, noise_offset=0.05)
    jst = jts.TrainStatics(
        unet_config=jm.unet_config, vae_config=jm.vae_config,
        text_config=jm.text_encoder_config, text_config_2=None,
        scheduler_config=jm.scheduler_config, compute_dtype=jnp.float32, **kw)
    tst = tts.TrainStatics(
        unet_config=tm.unet_config, vae_config=tm.vae_config,
        text_config=tm.text_encoder_config, text_config_2=None,
        scheduler_config=tm.scheduler_config, compute_dtype=torch.float32, **kw)
    r = np.random.default_rng(1)
    batch = {"pixel_values": r.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32),
             "input_ids": np.asarray(tm.tokenizer(["a cat", "a red dog"])).astype(np.int32)}
    key = jax.random.key(7)
    frozen_j = {"vae": jm.vae_params, "text_encoder": jm.text_encoder_params}
    loss_ref, g_ref = jax.jit(jax.value_and_grad(jts.full_finetune_loss_fn),
                              static_argnums=(4, 5))(
        jm.unet_params, frozen_j, jax.tree_util.tree_map(jnp.asarray, batch), key, jst,
        JDDPM(jst.scheduler_config))
    masters = {n: p.detach().clone().requires_grad_(True)
               for n, p in tm.unet.named_parameters()}
    frozen_t = {"unet": tm.unet, "vae": tm.vae, "text_encoder": tm.text_encoder}
    loss = tts.full_finetune_loss_fn(
        masters, frozen_t, {k: torch.from_numpy(v) for k, v in batch.items()}, None, tst,
        DDPMScheduler(tst.scheduler_config), draws=_draws(key, tm))
    grads = dict(zip(masters, torch.autograd.grad(loss, list(masters.values()))))
    _close(loss.item(), float(loss_ref), "loss")
    ref = _torch_named(jax.tree_util.tree_map(np.asarray, g_ref))
    assert sorted(ref) == sorted(grads)
    for n, g in grads.items():
        _close(g.numpy(), ref[n], n)


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    """Three full fine-tuning steps with an EMA at decay 0.5 through the JAX
    trainer, and the port's from the same weights and draws."""
    out = tmp_path_factory.mktemp("ff")
    tm = tiny_port_model(seed=2)
    initial = {n: p.detach().clone() for n, p in tm.unet.named_parameters()}
    jm = to_jax_model(tm)
    kw = dict(use_ema=True, ema_decay=0.5)
    jt = JTrainer(jm, _args(JArgs, out / "jax", **kw), data_dir)
    jema = _torch_named(jax.tree_util.tree_map(np.asarray, jt.train()))
    k_loop = jax.random.split(as_key(SEED), 4)[3]
    step_keys = []
    for _ in range(STEPS):
        k_loop, k_step = jax.random.split(k_loop)
        step_keys.append(k_step)
    draws = lambda step: _draws(step_keys[step], tm)  # noqa: E731
    tt = SDLoRATrainer(tm, _args(SDTrainingArgs, out / "port", **kw), data_dir, draws=draws)
    tema = tt.train()
    return jt, jema, tt, tema, tm, initial, draws


def test_trainer_matches_jax(trained):
    """The logged losses and every EMA'd UNet weight within REL_TOL of the
    JAX trainer's; the weights moved by far more than that (so the
    comparison sees the steps), and the model holds the EMA."""
    jt, jema, tt, tema, tm, initial, _ = trained
    assert [s for s, _ in tt.history] == [s for s, _ in jt.history] == [1, 2, 3]
    for (_, a), (_, b) in zip(tt.history, jt.history):
        _close(a, b, "logged loss")
    assert sorted(tema) == sorted(jema) == sorted(initial)
    moves = []
    for n, t in tema.items():
        _close(t.numpy(), jema[n], n)
        moves.append(((t - initial[n]).abs().max() / initial[n].abs().max()).item())
    assert min(moves) > 0 and np.median(moves) > 10 * REL_TOL, np.median(moves)
    for n, p in tm.unet.named_parameters():
        assert torch.equal(p, tema[n]), n


def test_saved_folder_loads_in_both_packages(trained):
    """The port's folder reloads through the port's loader with every UNet
    tensor equal to the EMA, and through the JAX loader within 1e-4 of the
    JAX trainer's EMA."""
    jt, jema, tt, tema, *_ = trained
    out = tt.args.output_dir
    for sub in ("unet", "vae", "text_encoder", "scheduler", "tokenizer"):
        assert os.path.isdir(os.path.join(out, sub)), sub
    reloaded = load_sd_model(out, model_type="sd15", device="cpu", dtype=torch.float32)
    for n, p in reloaded.unet.named_parameters():
        assert torch.equal(p, tema[n]), n
    jax_side = _torch_named(jax.tree_util.tree_map(
        np.asarray, jax_load_sd_model(out, model_type="sd15").unet_params))
    for n, a in jax_side.items():
        _close(a, jema[n], n)


def test_ema_equals_an_fp32_recomputation(data_dir, tmp_path, trained, monkeypatch):
    """The EMA after three steps equals e = d e + (1 - d) p applied by hand,
    in fp64, to the raw weights of each step (a run without the EMA hands
    them to its checkpoint writer, which records them instead)."""
    *_, initial, draws = trained
    raws = []

    def record(output_dir, step, state, total_limit=None):
        raws.append({n: t.clone() for n, t in state["unet"].items()})

    monkeypatch.setattr(ckpt, "save_checkpoint", record)
    SDLoRATrainer(tiny_port_model(seed=2),
                  _args(SDTrainingArgs, tmp_path / "raw", checkpointing_steps=1),
                  data_dir, draws=draws).train()
    assert len(raws) == STEPS
    ema = {n: t.double() for n, t in initial.items()}
    for raw in raws:
        ema = {n: 0.5 * e + 0.5 * raw[n].double() for n, e in ema.items()}
    for n, t in trained[3].items():
        torch.testing.assert_close(t.double(), ema[n], rtol=0,
                                   atol=1e-6 * max(1.0, ema[n].abs().max().item()))


def test_8bit_adam_and_resume(data_dir, tmp_path):
    """Full fine-tuning with the 8-bit Adam moves every weight; four steps
    straight equal two and a resume for two more, the EMA too, bit for
    bit."""
    kw = dict(max_train_steps=4, use_8bit_adam=True, use_ema=True, ema_decay=0.9,
              checkpointing_steps=2)
    straight = SDLoRATrainer(tiny_port_model(seed=5), _args(SDTrainingArgs, tmp_path / "a", **kw),
                             data_dir).train()
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "checkpoint-2", tmp_path / "b" / "checkpoint-2")
    trainer = SDLoRATrainer(tiny_port_model(seed=5),
                            _args(SDTrainingArgs, tmp_path / "b",
                                  resume_from_checkpoint="latest", **kw), data_dir)
    resumed = trainer.train()
    assert [s for s, _ in trainer.history] == [3, 4]
    init = dict(tiny_port_model(seed=5).unet.named_parameters())
    for n, t in straight.items():
        assert torch.equal(t, resumed[n]), n
        assert not torch.equal(t, init[n]), n


@pytest.mark.parametrize("kw, match", [
    (dict(train_text_encoder=True), "UNet only"),
    (dict(full_finetune=False, use_ema=True), "full_finetune"),
])
def test_refusals_match_jax(data_dir, tmp_path, kw, match):
    for args, trainer, model in ((JArgs, JTrainer, to_jax_model(tiny_port_model())),
                                 (SDTrainingArgs, SDLoRATrainer, tiny_port_model())):
        with pytest.raises(ValueError, match=match):
            trainer(model, _args(args, tmp_path, **kw), data_dir).train()


def test_saved_folder_keeps_the_fp32_ema_of_a_bf16_unet(data_dir, tmp_path):
    """A UNet held in bf16 (as on the card) trains fp32 masters; its saved
    folder holds their fp32 EMA, tensor for tensor, and not a bf16 copy:
    at decay 0.99 the EMA moves far less than one bf16 step, so a bf16
    copy would be the untrained UNet."""
    from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile

    tm = tiny_port_model(seed=6)
    tm.unet.to(torch.bfloat16)
    initial = {n: p.detach().float().clone() for n, p in tm.unet.named_parameters()}
    ema = SDLoRATrainer(tm, _args(SDTrainingArgs, tmp_path, use_ema=True, ema_decay=0.99,
                                  learning_rate=1e-4), data_dir).train()
    with SafetensorsFile(os.path.join(tmp_path, "unet",
                                      "diffusion_pytorch_model.safetensors")) as saved:
        assert sorted(saved.keys()) == sorted(ema)
        for n, t in ema.items():
            got = saved.torch_tensor(n)
            assert got.dtype == torch.float32 and torch.equal(got, t), n
            assert not torch.equal(t, initial[n]), n
    assert all(p.dtype == torch.float32 for p in tm.unet.parameters())
