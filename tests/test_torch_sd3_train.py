"""PyTorch/CUDA port: SD3 LoRA training against the JAX package, in fp32 on
the CPU with the tiny SD3 model (two MM-DiT blocks, CLIP-L, bigG, T5).

LoRA targets on both streams as JAX's; ``sd3_lora_loss_fn`` and every
factor's gradient against ``jax.value_and_grad`` (the JAX step's draws —
the latent sample, the density draw, the noise — injected), under the
logit-normal density with T5 and under sigma_sqrt weighting without it;
the whole ``SD3LoRATrainer`` over three steps on both sides from the same
folder and seed (JAX's initial factors and loop keys' draws handed in),
its file loading in the JAX package tensor for tensor.  The port alone:
``cache_latents`` gives the unsplit step exactly (JAX's
``test_split_encode_exact_equivalence``), every remat policy gives the
loss and gradients of none, and a resume ends where the straight run ends.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core.rng import as_key
from stablediffusion_tpu.io.safetensors_io import load_safetensors
from stablediffusion_tpu.lora import core as jlora_core
from stablediffusion_tpu.schedulers.flow_match import FlowMatchEulerScheduler as JFlow
from stablediffusion_tpu.train import sd3_train as jsd3
from stablediffusion_tpu_torch.io.from_jax import lora_from_jax
from stablediffusion_tpu_torch.lora.core import linear_module_paths
from stablediffusion_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
from stablediffusion_tpu_torch.train import sd3_train as tsd3
from stablediffusion_tpu_torch.train.optim import tree_leaves
from stablediffusion_tpu_torch.utils.testing import write_image_folder
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_sd3_port_model,
    to_jax_sd3_model,
)

REL_TOL = 1e-4
STEPS, BATCH, RES, SEED, RANK, T5_LEN = 3, 2, 16, 4, 4, 16


def _close(out, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


def _draws(key, tm, uniform=False):
    """The JAX step's draws for `key` (sd3_train.py:133-175), NCHW."""
    k_sample, k_noise, k_t = jax.random.split(key, 3)
    h = RES // tm.vae_scale_factor
    shape = (BATCH, h, h, tm.vae_config.latent_channels)
    nchw = lambda a: torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))  # noqa: E731
    density = (jax.random.uniform(k_t, (BATCH,), jnp.float32) if uniform
               else jax.random.normal(k_t, (BATCH,), jnp.float32))
    return {"latent_eps": nchw(jax.random.normal(k_sample, shape, jnp.float32)),
            "noise": nchw(jax.random.normal(k_noise, shape, jnp.float32)),
            "density": torch.from_numpy(np.array(density))}


def _statics(tm, jm, **kw):
    jst = jsd3.SD3TrainStatics(
        transformer_config=jm.transformer_config, vae_config=jm.vae_config,
        text_config=jm.text_encoder_config, text_config_2=jm.text_encoder_2_config,
        text_config_3=jm.text_encoder_3_config, scheduler_config=jm.scheduler_config,
        compute_dtype=jnp.float32, **kw)
    tst = tsd3.SD3TrainStatics(
        transformer_config=tm.transformer_config, vae_config=tm.vae_config,
        text_config=tm.text_encoder_config, text_config_2=tm.text_encoder_2_config,
        text_config_3=tm.text_encoder_3_config, scheduler_config=tm.scheduler_config,
        compute_dtype=torch.float32, **kw)
    return jst, tst


def _frozen(tm, jm):
    names = ["transformer", "vae", "text_encoder", "text_encoder_2"]
    if tm.text_encoder_3 is not None:
        names.append("text_encoder_3")
    return ({n: getattr(jm, f"{n}_params") for n in names},
            {n: getattr(tm, n) for n in names})


def _batch(tm, with_t5):
    r = np.random.default_rng(3)
    captions = ["a cat", "a red dog on a mat"]
    batch = {"pixel_values": (r.standard_normal((BATCH, RES, RES, 3)) * 0.3).astype(np.float32),
             "input_ids": np.asarray(tm.tokenizer(captions)).astype(np.int32),
             "input_ids_2": np.asarray(tm.tokenizer_2(captions)).astype(np.int32)}
    if with_t5:
        batch["input_ids_3"] = np.asarray(tm.tokenizer_3(captions, max_length=T5_LEN)
                                          ).astype(np.int32)
    return batch


def _jax_lora(jm, key=jax.random.key(1)):
    """JAX factors with non-zero `up` (zeros give zero `down` gradients)."""
    tree = jax.tree_util.tree_map(np.asarray, jlora_core.init_lora(
        key, jm.transformer_params, RANK, jsd3.MMDIT_TARGET_SUFFIXES, store_alpha=False))
    r = np.random.default_rng(5)
    for f in tree.values():
        f["up"] = (r.standard_normal(f["up"].shape) * 0.05).astype(np.float32)
    return {"transformer": tree}


@pytest.fixture(scope="module")
def models():
    tm = tiny_sd3_port_model(seed=2)
    return tm, to_jax_sd3_model(tm)


def test_targets_both_streams(models):
    tm, jm = models
    paths = linear_module_paths(tm.transformer, tsd3.MMDIT_TARGET_SUFFIXES)
    assert paths == sorted(_jax_lora(jm)["transformer"])
    assert any("add_q_proj" in p for p in paths) and any("to_add_out" in p for p in paths)
    last = f"transformer_blocks.{tm.transformer_config.num_layers - 1}."
    assert not any(p.startswith(last) and "to_add_out" in p for p in paths)


@pytest.mark.parametrize("scheme, with_t5", [("logit_normal", True), ("sigma_sqrt", False)])
def test_loss_and_lora_grads_match_jax(models, scheme, with_t5):
    tm, jm = models
    jst, tst = _statics(tm, jm, weighting_scheme=scheme, logit_mean=0.3, logit_std=1.2)
    if not with_t5:
        jst = dataclasses.replace(jst, text_config_3=None)
        tst = dataclasses.replace(tst, text_config_3=None)
    frozen_j, frozen_t = _frozen(tm, jm)
    batch = _batch(tm, with_t5)
    lora = _jax_lora(jm)
    key = jax.random.key(7)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(jsd3.sd3_lora_loss_fn), static_argnums=(4, 5))(
        lora, frozen_j, jax.tree_util.tree_map(jnp.asarray, batch), key, jst,
        JFlow(jst.scheduler_config))
    trainable = {"transformer": lora_from_jax(lora["transformer"])}
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(trainable)]
    loss = tsd3.sd3_lora_loss_fn(
        trainable, frozen_t, {k: torch.from_numpy(v) for k, v in batch.items()}, None, tst,
        FlowMatchEulerScheduler(tst.scheduler_config),
        draws=_draws(key, tm, uniform=scheme != "logit_normal"))
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), float(loss_ref), "loss")
    ref = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))
    dead = []
    for (path, _), g in zip(tree_leaves(trainable), grads):
        if not ref[path].any():  # the last block's text queries feed nothing
            assert not g.any(), path
            dead.append(path)
        else:
            _close(g.numpy(), ref[path], path)
    last = f"transformer_blocks.{tm.transformer_config.num_layers - 1}.attn.add_q_proj"
    assert dead == [f"transformer.{last}.down", f"transformer.{last}.up"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_image_folder(str(tmp_path_factory.mktemp("data")), 4, (24, 24), seed=0)


def _args(mod, out, **kw):
    # Adam's eps at the factors' gradients' scale: at a smaller eps an
    # element whose gradient is near eps moves by a step whose size its
    # last bits decide, and the two packages sum in other orders
    base = dict(train_batch_size=BATCH, max_train_steps=STEPS, resolution=RES, rank=RANK,
                mixed_precision="no", max_sequence_length=T5_LEN, learning_rate=1e-3,
                adam_epsilon=1e-2, seed=SEED, output_dir=str(out), log_every=1)
    base.update(kw)
    return mod(**base)


def _jax_inputs(jm):
    """The JAX trainer's initial factors and each step's draws' key."""
    k_lora, k_loop = jax.random.split(as_key(SEED))
    initial = {"transformer": lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora_core.init_lora(
        k_lora, jm.transformer_params, RANK, jsd3.MMDIT_TARGET_SUFFIXES, store_alpha=False)))}
    keys = []
    for _ in range(STEPS):
        k_loop, k_step = jax.random.split(k_loop)
        keys.append(k_step)
    return initial, keys


def test_trainer_matches_jax(models, data_dir, tmp_path):
    """Three steps of SD3LoRATrainer on both sides; the port's file loads in
    the JAX package with every tensor equal to its factors."""
    tm, jm = models
    jt = jsd3.SD3LoRATrainer(jm, _args(jsd3.SD3TrainingArgs, tmp_path / "jax"), data_dir)
    jlora = jax.tree_util.tree_map(np.asarray, jt.train())
    initial, keys = _jax_inputs(jm)
    tt = tsd3.SD3LoRATrainer(tm, _args(tsd3.SD3TrainingArgs, tmp_path / "port"), data_dir,
                             initial=initial, draws=lambda s: _draws(keys[s], tm))
    tlora = tt.train()
    assert [s for s, _ in tt.history] == [s for s, _ in jt.history] == [1, 2, 3]
    for (_, a), (_, b) in zip(tt.history, jt.history):
        _close(a, b, "logged loss")
    ref = dict(tree_leaves(jlora))
    for path, t in tree_leaves(tlora):
        _close(t.numpy(), ref[path], path)
    flat = load_safetensors(f"{tt.args.output_dir}/pytorch_lora_weights.safetensors")
    assert sorted(flat) == sorted(load_safetensors(
        f"{jt.args.output_dir}/pytorch_lora_weights.safetensors"))
    for path, f in tlora["transformer"].items():
        np.testing.assert_array_equal(flat[f"transformer.{path}.lora_A.weight"],
                                      f["down"].numpy().T)
        np.testing.assert_array_equal(flat[f"transformer.{path}.lora_B.weight"],
                                      f["up"].numpy().T)


def test_split_encode_exact_equivalence(models):
    """make_sd3_encode_fn then the loss on its batch gives the fused loss
    bit for bit, with the same draws (and so the trainer with
    cache_latents the same factors)."""
    tm, jm = models
    _, tst = _statics(tm, jm)
    _, frozen_t = _frozen(tm, jm)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm, True).items()}
    trainable = {"transformer": lora_from_jax(_jax_lora(jm)["transformer"])}
    draws = _draws(jax.random.key(9), tm)
    sched = FlowMatchEulerScheduler(tst.scheduler_config)
    with torch.no_grad():
        enc = tsd3.make_sd3_encode_fn(tst)(frozen_t, batch, None, draws)
        assert {"latents", "prompt_embeds", "pooled_embeds"} <= set(enc)
        assert not {"pixel_values", "input_ids", "input_ids_2", "input_ids_3"} & set(enc)
        fused = tsd3.sd3_lora_loss_fn(trainable, frozen_t, batch, None, tst, sched, draws)
        split = tsd3.sd3_lora_loss_fn(trainable, frozen_t, enc, None, tst, sched, draws)
    assert torch.equal(fused, split)


@pytest.mark.parametrize("policy", ["full", "dots", "offload"])
def test_remat_policies_match_none(models, policy):
    """Every remat policy gives the loss and every factor's gradient of no
    remat within 1e-6 (it changes what the backward keeps, not the sums)."""
    tm, jm = models
    _, tst = _statics(tm, jm)
    _, frozen_t = _frozen(tm, jm)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm, True).items()}
    draws = _draws(jax.random.key(5), tm)
    out = []
    for p in ("none", policy):
        trainable = {"transformer": lora_from_jax(_jax_lora(jm)["transformer"])}
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(trainable)]
        loss = tsd3.sd3_lora_loss_fn(trainable, frozen_t, batch, None,
                                     dataclasses.replace(tst, remat_policy=p),
                                     FlowMatchEulerScheduler(tst.scheduler_config), draws)
        out.append([loss.detach()] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6 * max(1.0, a.abs().max().item()))


def test_cache_latents_and_resume(models, data_dir, tmp_path):
    """Four steps straight (the latents and embeddings encoded apart,
    cache_latents), against two and a resume from checkpoint-2 for two
    more: the factors end bit for bit equal; and cache_latents' factors
    equal the unsplit trainer's."""
    tm, _ = models
    kw = dict(max_train_steps=4, checkpointing_steps=2)
    runs = {}
    for cache in (False, True):
        runs[cache] = tsd3.SD3LoRATrainer(
            tm, _args(tsd3.SD3TrainingArgs, tmp_path / f"c{cache}", cache_latents=cache, **kw),
            data_dir).train()
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "cTrue" / "checkpoint-2", tmp_path / "b" / "checkpoint-2")
    trainer = tsd3.SD3LoRATrainer(
        tm, _args(tsd3.SD3TrainingArgs, tmp_path / "b", cache_latents=True,
                  resume_from_checkpoint="latest", **kw), data_dir)
    resumed = trainer.train()
    assert [s for s, _ in trainer.history] == [3, 4]
    for (p, a), (_, b), (_, c) in zip(tree_leaves(runs[True]), tree_leaves(resumed),
                                      tree_leaves(runs[False])):
        assert torch.equal(a, b), p
        assert torch.equal(a, c), p


def test_mesh_and_sharding_refused(models):
    """A mesh is taken (the multi-process paths are test_torch_parallel.py's);
    sharded state without one is refused, as in JAX."""
    from stablediffusion_tpu_torch.parallel import make_mesh

    tm, _ = models
    trainer = tsd3.SD3LoRATrainer(tm, tsd3.SD3TrainingArgs(), "unused", mesh=make_mesh())
    assert trainer.plan.mesh is not None
    with pytest.raises(ValueError, match="pass a mesh"):
        tsd3.SD3LoRATrainer(tm, tsd3.SD3TrainingArgs(shard_params=True), "unused")


def test_args_and_statics_match_jax():
    """Every field and default of SD3TrainingArgs and SD3TrainStatics."""
    for jcls, tcls in ((jsd3.SD3TrainingArgs, tsd3.SD3TrainingArgs),
                       (jsd3.SD3TrainStatics, tsd3.SD3TrainStatics)):
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        assert sorted(tf) == sorted(jf)
        assert {k: v for k, v in tf.items() if k != "compute_dtype"} == \
            {k: v for k, v in jf.items() if k != "compute_dtype"}
    assert tsd3.MMDIT_TARGET_SUFFIXES == jsd3.MMDIT_TARGET_SUFFIXES
