"""PyTorch/CUDA port: DreamBooth training against the JAX package, in fp32 on
the CPU with the tiny SD1.5 model.

The prior-loss split of ``_prediction_loss`` against JAX's; the trainer
with prior preservation on both sides over the same instance and class
folders (the paired dataset copy gives the same [instance | class]
batches; the JAX loop keys' draws and initial factors handed to the port):
two steps' losses and the LoRA factors within 1e-4; the instance prompt
alone in place of the folder's captions, likewise.  The port alone: the
class images rendered into an empty class folder by the port's pipeline,
and the JAX trainer's refusals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core.rng import as_key
from stablediffusion_tpu.lora import core as jlora_core
from stablediffusion_tpu.schedulers import DDPMScheduler as JDDPM
from stablediffusion_tpu.train import train_step as jts
from stablediffusion_tpu.train.trainer import SDLoRATrainer as JTrainer
from stablediffusion_tpu.train.trainer import SDTrainingArgs as JArgs
from stablediffusion_tpu_torch.io.from_jax import lora_from_jax
from stablediffusion_tpu_torch.schedulers import DDPMScheduler
from stablediffusion_tpu_torch.train import train_step as tts
from stablediffusion_tpu_torch.train.optim import tree_leaves
from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
from stablediffusion_tpu_torch.utils.testing import write_image_folder
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_port_model,
    to_jax_model,
)

REL_TOL = 1e-4
STEPS, BATCH, RES, SEED, RANK = 2, 2, 32, 4, 2
INSTANCE, CLASS = "a photo of sks dog", "a photo of dog"


def _close(out, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


def _draws(key, batch, tm):
    """The JAX step's draws for `key` (train_step.py:157-190), NCHW."""
    k_sample, k_noise, k_t, _ = jax.random.split(key, 4)
    h = RES // tm.vae_scale_factor
    shape = (batch, h, h, tm.vae_config.latent_channels)
    nchw = lambda a: torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))  # noqa: E731
    return {"latent_eps": nchw(jax.random.normal(k_sample, shape, jnp.float32)),
            "noise": nchw(jax.random.normal(k_noise, shape, jnp.float32)),
            "timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (batch,), 0, 1000)))}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("db")
    inst = write_image_folder(str(root / "instance"), 4, (40, 40), seed=1)
    cls = write_image_folder(str(root / "class"), 3, (48, 40), seed=2)
    return inst, cls, root


def _args(mod, out, **kw):
    base = dict(train_batch_size=BATCH, resolution=RES, max_train_steps=STEPS, rank=RANK,
                learning_rate=1e-3, lr_scheduler="constant", lr_warmup_steps=0,
                mixed_precision="no", train_text_encoder=False, adam_epsilon=1e-4, seed=SEED,
                instance_prompt=INSTANCE, output_dir=str(out), log_every=1, report_to=None)
    base.update(kw)
    return mod(**base)


def test_prior_loss_split_matches_jax():
    m = tiny_port_model()
    jm = to_jax_model(m)
    r = np.random.default_rng(0)
    pred, noise = (r.standard_normal((4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    lat = np.zeros((4, 8, 8, 4), np.float32)
    ts = np.array([10, 20, 30, 40])
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2))  # noqa: E731
    for w in (0.5, 0.0, None):
        jst = jts.TrainStatics(
            unet_config=jm.unet_config, vae_config=jm.vae_config,
            text_config=jm.text_encoder_config, text_config_2=None,
            scheduler_config=jm.scheduler_config, train_text_encoder=False, snr_gamma=None,
            prior_loss_weight=w)
        tst = tts.TrainStatics(
            unet_config=m.unet_config, vae_config=m.vae_config,
            text_config=m.text_encoder_config, text_config_2=None,
            scheduler_config=m.scheduler_config, train_text_encoder=False, snr_gamma=None,
            prior_loss_weight=w)
        ref = jts._prediction_loss(jnp.asarray(pred), jnp.asarray(lat), jnp.asarray(noise),
                                   jnp.asarray(ts), jst, JDDPM(jst.scheduler_config))
        got = tts._prediction_loss(nchw(pred), nchw(lat), nchw(noise), torch.from_numpy(ts),
                                   tst, DDPMScheduler(tst.scheduler_config))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def _run_both(model_seed, inst, out, B, **kw):
    """The JAX trainer, then the port's from JAX's initial factors and
    draws; returns both trainers and both factor trees."""
    tm = tiny_port_model(seed=model_seed)
    jm = to_jax_model(tm)
    jt = JTrainer(jm, _args(JArgs, out / "jax", **kw), inst)
    jlora = jax.tree_util.tree_map(np.asarray, jt.train())
    k_unet, _, _, k_loop = jax.random.split(as_key(SEED), 4)
    initial = {"unet": lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora_core.init_lora(
        k_unet, jm.unet_params, RANK, jlora_core.UNET_TARGET_SUFFIXES, store_alpha=False)))}
    keys = []
    for _ in range(STEPS):
        k_loop, k_step = jax.random.split(k_loop)
        keys.append(k_step)
    tt = SDLoRATrainer(tm, _args(SDTrainingArgs, out / "port", **kw), inst, initial=initial,
                       draws=lambda step: _draws(keys[step], B, tm))
    return jt, jlora, tt, tt.train()


def _check(jt, jlora, tt, tlora):
    assert [s for s, _ in tt.history] == [s for s, _ in jt.history] == [1, 2]
    for (_, a), (_, b) in zip(tt.history, jt.history):
        _close(a, b, "logged loss")
    ref = dict(tree_leaves(jlora))
    for path, t in tree_leaves(tlora):
        _close(t.numpy(), ref[path], path)
    assert os.path.exists(f"{tt.args.output_dir}/pytorch_lora_weights.safetensors")


def test_prior_preservation_trainer_matches_jax(dirs, tmp_path):
    """[instance | class] batches of 2 + 2 images (the class folder already
    full, so neither side renders), the class half at weight 0.7."""
    inst, cls, _ = dirs
    kw = dict(with_prior_preservation=True, class_data_dir=cls, class_prompt=CLASS,
              num_class_images=3, prior_loss_weight=0.7)
    _check(*_run_both(6, inst, tmp_path, 2 * BATCH, **kw))
    assert len(os.listdir(cls)) == 6  # 3 JPEGs and their captions, untouched


def test_instance_prompt_trainer_matches_jax(dirs, tmp_path):
    """instance_prompt without prior preservation replaces the captions."""
    inst, _, _ = dirs
    _check(*_run_both(7, inst, tmp_path, BATCH))


def test_class_images_rendered_by_the_port(dirs, tmp_path):
    """An empty class folder is topped up to num_class_images by the
    model's own renders (in batches of sample_batch_size), then trained
    on."""
    inst, _, root = dirs
    gen = str(root / "gen-class")
    args = _args(SDTrainingArgs, tmp_path, with_prior_preservation=True, class_data_dir=gen,
                 class_prompt=CLASS, num_class_images=3, sample_batch_size=2,
                 prior_loss_weight=0.7)
    trainer = SDLoRATrainer(tiny_port_model(seed=8), args, inst)
    lora = trainer.train()
    assert sorted(os.listdir(gen)) == ["class-0.jpg", "class-1.jpg", "class-2.jpg"]
    from PIL import Image

    assert Image.open(os.path.join(gen, "class-0.jpg")).size == (RES, RES)
    assert trainer.history and np.isfinite(trainer.history[-1][1]) and "unet" in lora


@pytest.mark.parametrize("kw, match", [
    (dict(with_prior_preservation=True), "class_prompt"),
    (dict(with_prior_preservation=True, class_prompt="y", class_data_dir="/nonexistent/zz",
          textual_inversion="<t>", ti_initializer_token="cat"), "textual_inversion"),
])
def test_refusals_match_jax(dirs, tmp_path, kw, match):
    inst, _, _ = dirs
    for args, trainer, model in ((JArgs, JTrainer, to_jax_model(tiny_port_model())),
                                 (SDTrainingArgs, SDLoRATrainer, tiny_port_model())):
        with pytest.raises(ValueError, match=match):
            trainer(model, _args(args, tmp_path, **kw), inst).train()
