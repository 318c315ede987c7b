"""PyTorch/CUDA port: textual-inversion training against the JAX package, in
fp32 on the CPU with the tiny SD1.5 and SDXL models.

``ti_loss_fn`` and the gradients of the placeholder's rows (SD1.5, and
SDXL's rows in both towers) against ``jax.value_and_grad`` with the JAX
step's draws injected; then the SDXL trainer's three dual-tower steps on
both sides from the same folder and seed (the same caption templates, the
JAX loop keys' draws through ``draws=``): the losses, both towers' rows and
the ``{clip_l, clip_g}`` learned_embeds file within 1e-4, every other row of
both tables equal to the original.  The port alone: the SD1.5 trainer's
file loads into a fresh model whose trigger renders the trained model's
image exactly, a resume equal to the straight run, the CLI, and the JAX
trainer's refusals.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core.rng import as_key
from stablediffusion_tpu.io.safetensors_io import load_safetensors
from stablediffusion_tpu.schedulers import DDPMScheduler as JDDPM
from stablediffusion_tpu.train import train_step as jts
from stablediffusion_tpu.train.trainer import SDLoRATrainer as JTrainer
from stablediffusion_tpu.train.trainer import SDTrainingArgs as JArgs
from stablediffusion_tpu_torch.io.loader import save_sd_model
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.schedulers import DDPMScheduler
from stablediffusion_tpu_torch.train import cli
from stablediffusion_tpu_torch.train import train_step as tts
from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
from stablediffusion_tpu_torch.utils.testing import write_image_folder
from torch_port_helpers import (  # noqa: F401
    _jax_cfg,
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

REL_TOL = 1e-4
STEPS, BATCH, RES, SEED, V = 3, 2, 32, 4, 2
TOKEN = "<thing>"


def _close(out, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


def _draws(key, tm):
    """The JAX step's draws for `key` (train_step.py:157-190), NCHW."""
    k_sample, k_noise, k_t, _ = jax.random.split(key, 4)
    h = RES // tm.vae_scale_factor
    shape = (BATCH, h, h, tm.vae_config.latent_channels)
    nchw = lambda a: torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))  # noqa: E731
    return {"latent_eps": nchw(jax.random.normal(k_sample, shape, jnp.float32)),
            "noise": nchw(jax.random.normal(k_noise, shape, jnp.float32)),
            "timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (BATCH,), 0, 1000)))}


def _table(encoder):
    return encoder.text_model.embeddings.token_embedding.weight.detach().clone()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_image_folder(str(tmp_path_factory.mktemp("data")), 4, (40, 48), seed=0)


def _args(mod, out, **kw):
    base = dict(train_batch_size=BATCH, resolution=RES, max_train_steps=STEPS,
                learning_rate=5e-3, lr_scheduler="constant", lr_warmup_steps=0,
                mixed_precision="no", train_text_encoder=False, textual_inversion=TOKEN,
                ti_initializer_token="cat", ti_num_vectors=V, seed=SEED,
                output_dir=str(out), log_every=1, report_to=None)
    base.update(kw)
    return mod(**base)


@pytest.mark.parametrize("sdxl", [False, True])
def test_loss_and_row_grads_match_jax(sdxl):
    """The rows spliced into the towers' tables, the loss and the rows'
    gradients against jax.value_and_grad(ti_loss_fn)."""
    tm = tiny_sdxl_port_model(seed=3) if sdxl else tiny_port_model(seed=3)
    r = np.random.default_rng(2)
    rows = {"embeddings": r.standard_normal((V, 32)).astype(np.float32) * 0.1}
    n1 = tm.text_encoder.text_model.embeddings.token_embedding.weight.shape[0]
    ti_rows = tuple(range(n1, n1 + V))
    if sdxl:
        rows["embeddings_2"] = r.standard_normal((V, 32)).astype(np.float32) * 0.1
        tm.load_textual_inversion({"clip_l": rows["embeddings"], "clip_g": rows["embeddings_2"]},
                                  token=TOKEN)
    else:
        tm.load_textual_inversion({TOKEN: rows["embeddings"]})
    jm = to_jax_model(tm)  # the tables with the appended rows
    captions = [f"a photo of a {TOKEN}", f"a {TOKEN} on a table"]
    batch = {"pixel_values": r.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32),
             "input_ids": np.asarray(tm.tokenizer(captions)).astype(np.int32)}
    assert set(ti_rows) <= set(batch["input_ids"].ravel().tolist())
    if sdxl:
        batch["input_ids_2"] = np.asarray(tm.tokenizer_2(captions)).astype(np.int32)
        batch["original_sizes"] = np.full((BATCH, 2), RES, np.float32)
        batch["crop_top_lefts"] = np.zeros((BATCH, 2), np.float32)
        batch["target_sizes"] = np.full((BATCH, 2), RES, np.float32)
    kw = dict(train_text_encoder=False, snr_gamma=5.0, ti_rows=ti_rows,
              ti_rows_2=ti_rows if sdxl else None)
    c2 = tm.text_encoder_2_config if sdxl else None
    jst = jts.TrainStatics(
        unet_config=jm.unet_config, vae_config=jm.vae_config,
        text_config=jm.text_encoder_config,
        text_config_2=_jax_cfg(type(jm.text_encoder_config), c2) if sdxl else None,
        scheduler_config=jm.scheduler_config, compute_dtype=jnp.float32, **kw)
    tst = tts.TrainStatics(
        unet_config=tm.unet_config, vae_config=tm.vae_config,
        text_config=tm.text_encoder_config, text_config_2=c2,
        scheduler_config=tm.scheduler_config, compute_dtype=torch.float32, **kw)
    frozen_j = {"unet": jm.unet_params, "vae": jm.vae_params,
                "text_encoder": jm.text_encoder_params}
    frozen_t = {"unet": tm.unet, "vae": tm.vae, "text_encoder": tm.text_encoder}
    if sdxl:
        frozen_j["text_encoder_2"] = jm.text_encoder_2_params
        frozen_t["text_encoder_2"] = tm.text_encoder_2
    # trained rows apart from the tables' (the splice must take them)
    trained = {k: v + 0.05 for k, v in rows.items()}
    key = jax.random.key(7)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(jts.ti_loss_fn), static_argnums=(4, 5))(
        jax.tree_util.tree_map(jnp.asarray, trained), frozen_j,
        jax.tree_util.tree_map(jnp.asarray, batch), key, jst, JDDPM(jst.scheduler_config))
    tables = {c: _table(getattr(tm, c)) for c in frozen_t if c.startswith("text")}
    ti = {k: torch.from_numpy(v).requires_grad_(True) for k, v in trained.items()}
    loss = tts.ti_loss_fn(ti, frozen_t, {k: torch.from_numpy(v) for k, v in batch.items()},
                          None, tst, DDPMScheduler(tst.scheduler_config),
                          draws=_draws(key, tm))
    grads = torch.autograd.grad(loss, list(ti.values()))
    _close(loss.item(), float(loss_ref), "loss")
    for (name, _), g in zip(ti.items(), grads):
        assert np.abs(np.asarray(g_ref[name])).max() > 0, name
        _close(g.numpy(), np.asarray(g_ref[name]), name)
    for c, t in tables.items():  # the splice wrote nothing into the modules
        assert torch.equal(_table(getattr(tm, c)), t), c


@pytest.fixture(scope="module")
def trained_sdxl(data_dir, tmp_path_factory):
    """Three dual-tower TI steps through the JAX trainer and the port's,
    from the same weights, folder, seed and draws."""
    out = tmp_path_factory.mktemp("ti")
    tm = tiny_sdxl_port_model(seed=2)
    tables = {c: _table(getattr(tm, c)) for c in ("text_encoder", "text_encoder_2")}
    jm = to_jax_model(tm)
    jt = JTrainer(jm, _args(JArgs, out / "jax"), data_dir)
    jrows = jax.tree_util.tree_map(np.asarray, jt.train())
    k_loop = jax.random.split(as_key(SEED), 4)[3]
    step_keys = []
    for _ in range(STEPS):
        k_loop, k_step = jax.random.split(k_loop)
        step_keys.append(k_step)
    tt = SDLoRATrainer(tm, _args(SDTrainingArgs, out / "port"), data_dir,
                       draws=lambda step: _draws(step_keys[step], tm))
    trows = tt.train()
    return jt, jm, jrows, tt, tm, trows, tables


def test_sdxl_trainer_matches_jax(trained_sdxl):
    jt, jm, jrows, tt, tm, trows, tables = trained_sdxl
    assert [s for s, _ in tt.history] == [s for s, _ in jt.history] == [1, 2, 3]
    for (_, a), (_, b) in zip(tt.history, jt.history):
        _close(a, b, "logged loss")
    assert sorted(trows) == sorted(jrows) == ["embeddings", "embeddings_2"]
    for k in trows:
        _close(trows[k].numpy(), jrows[k], k)
    # the rows moved from the initializer's row; every other row is the
    # original, in both towers; the trained rows are in the live tables
    for comp, key in (("text_encoder", "embeddings"), ("text_encoder_2", "embeddings_2")):
        orig, now = tables[comp], _table(getattr(tm, comp))
        n = orig.shape[0]
        assert now.shape[0] == n + V
        assert torch.equal(now[:n], orig), comp
        assert torch.equal(now[n:], trows[key]), comp
        init_id = int(np.asarray(getattr(tm, "tokenizer" if key == "embeddings"
                                         else "tokenizer_2")(["cat"]))[0][1])
        assert (trows[key] - orig[init_id]).abs().max() > 1e-5, comp


def test_sdxl_learned_embeds_file_matches_jax(trained_sdxl):
    """The {clip_l, clip_g} file holds the trained rows, within 1e-4 of the
    JAX trainer's file; it loads into a fresh port model with its trigger."""
    jt, _, _, tt, tm, trows, _ = trained_sdxl
    ours = load_safetensors(f"{tt.args.output_dir}/learned_embeds.safetensors")
    theirs = load_safetensors(f"{jt.args.output_dir}/learned_embeds.safetensors")
    assert sorted(ours) == sorted(theirs) == ["clip_g", "clip_l"]
    np.testing.assert_array_equal(ours["clip_l"], trows["embeddings"].numpy())
    np.testing.assert_array_equal(ours["clip_g"], trows["embeddings_2"].numpy())
    for k in ours:
        _close(ours[k], theirs[k], k)
    fresh = tiny_sdxl_port_model(seed=2)
    assert fresh.load_textual_inversion(f"{tt.args.output_dir}/learned_embeds.safetensors",
                                        token=TOKEN) == TOKEN
    for comp in ("text_encoder", "text_encoder_2"):
        assert torch.equal(_table(getattr(fresh, comp)), _table(getattr(tm, comp))), comp


def test_sd15_file_renders_the_trained_model(data_dir, tmp_path):
    """The SD1.5 trainer's diffusers learned_embeds file, loaded into a fresh
    model, renders the trained model's image exactly; without it the
    prompt renders another."""
    tm = tiny_port_model(seed=2)
    table = _table(tm.text_encoder)
    trainer = SDLoRATrainer(tm, _args(SDTrainingArgs, tmp_path), data_dir)
    rows = trainer.train()
    assert sorted(rows) == ["embeddings"] and rows["embeddings"].shape == (V, 32)
    now = _table(tm.text_encoder)
    assert torch.equal(now[:table.shape[0]], table)
    ids = np.asarray(tm.tokenizer([f"a photo of {TOKEN}"]))[0].tolist()
    assert table.shape[0] in ids and table.shape[0] + 1 in ids
    pipe = StableDiffusionUnifiedPipeline(device="cpu")
    kw = dict(prompt=f"a photo of {TOKEN}", height=RES, width=RES, num_inference_steps=2,
              seed=3)
    fresh = tiny_port_model(seed=2)
    base = pipe(fresh, **kw).images
    assert fresh.load_textual_inversion(f"{tmp_path}/learned_embeds.safetensors") == TOKEN
    loaded = pipe(fresh, **kw).images
    assert not np.array_equal(base, loaded)
    np.testing.assert_array_equal(loaded, pipe(tm, **kw).images)


def test_resume_equals_straight_run(data_dir, tmp_path):
    """Four steps straight against two and a resume for two more: the rows,
    the moments, the generator and the template draws come back, so the
    rows end bit for bit equal."""
    kw = dict(max_train_steps=4, checkpointing_steps=2)
    straight = SDLoRATrainer(tiny_port_model(seed=1), _args(SDTrainingArgs, tmp_path / "a", **kw),
                             data_dir).train()
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "checkpoint-2", tmp_path / "b" / "checkpoint-2")
    trainer = SDLoRATrainer(tiny_port_model(seed=1),
                            _args(SDTrainingArgs, tmp_path / "b",
                                  resume_from_checkpoint="latest", **kw), data_dir)
    resumed = trainer.train()
    assert [s for s, _ in trainer.history] == [3, 4]
    assert torch.equal(straight["embeddings"], resumed["embeddings"])


def test_cli_trains_an_embedding(data_dir, tmp_path):
    """--train_textual_inversion through cli.main writes the learned_embeds
    file and the model card."""
    folder = str(tmp_path / "model")
    save_sd_model(tiny_port_model(seed=5), folder)
    out = tmp_path / "out"
    cli.main(["--pretrained_model_name_or_path", folder, "--model_type", "sd15",
              "--train_data_dir", data_dir, "--device", "cpu", "--resolution", str(RES),
              "--train_batch_size", "2", "--max_train_steps", "2", "--mixed_precision", "no",
              "--report_to", "none", "--checkpointing_steps", "0",
              "--train_textual_inversion", "<cli-thing>", "--ti_initializer_token", "cat",
              "--validation_prompt", "a photo of <cli-thing>", "--num_validation_images", "1",
              "--output_dir", str(out)])
    assert sorted(load_safetensors(str(out / "learned_embeds.safetensors"))) == ["<cli-thing>"]
    assert os.path.exists(out / "README.md") and os.path.exists(out / "validation" / "0.png")


@pytest.mark.parametrize("kw, match", [
    (dict(ti_initializer_token=None), "ti_initializer_token"),
    (dict(ti_initializer_token="cat dog"), "single token"),
    (dict(train_text_encoder=True), "train_text_encoder=False"),
])
def test_refusals_match_jax(data_dir, tmp_path, kw, match):
    for args, trainer, model in ((JArgs, JTrainer, to_jax_model(tiny_port_model())),
                                 (SDTrainingArgs, SDLoRATrainer, tiny_port_model())):
        with pytest.raises(ValueError, match=match):
            trainer(model, _args(args, tmp_path, **kw), data_dir).train()
