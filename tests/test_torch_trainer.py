"""PyTorch/CUDA port: the LoRA trainer, its CLI and the handler's train mode
against the JAX package, in fp32 on the CPU with the tiny models.

The dataset copy gives the JAX dataset's batches, array for array, with and
without aspect-ratio buckets.  The whole trainer runs three SDXL steps with
text-encoder LoRA on both sides from the same folder and seed: the JAX
trainer's initial factors (its ``init_lora`` keys) and each step's draws
(its loop keys, split as ``_prepare_diffusion`` splits them) are handed to
the port through ``initial=`` and ``draws=``; the logged losses and the
final factors agree within 1e-4, and the port's saved peft and kohya files
load in the JAX package with tensors equal.  The port alone: a run resumed
from a checkpoint (8-bit moments, bf16 accumulation stopped half way) ends
where the straight run ends, bit for bit; ``cache_latents`` gives the fused
path's factors exactly; ``cli.main`` and the handler's train mode write the
file; the CLI writes the model card (JAX's, on the port's modules) and
pushes through a stand-in ``huggingface_hub``; the options ported with
ROADMAP item 19 each train a step, and those not ported raise and name
their item.
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
from stablediffusion_tpu.lora import core as jlora_core
from stablediffusion_tpu.lora.formats import load_lora_file as jax_load_lora_file
from stablediffusion_tpu.train import dataset as jdataset
from stablediffusion_tpu.train.trainer import SDLoRATrainer as JTrainer
from stablediffusion_tpu.train.trainer import SDTrainingArgs as JArgs
from stablediffusion_tpu_torch.io.from_jax import lora_from_jax
from stablediffusion_tpu_torch.io.loader import save_sd_model
from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile
from stablediffusion_tpu_torch.serve.handler import Handler
from stablediffusion_tpu_torch.train import checkpoint as ckpt
from stablediffusion_tpu_torch.train import cli
from stablediffusion_tpu_torch.train import dataset as tdataset
from stablediffusion_tpu_torch.train.optim import tree_leaves
from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
from stablediffusion_tpu_torch.utils.testing import write_image_folder
from torch_port_helpers import (  # noqa: F401
    port_test_module,
    tiny_port_model,
    tiny_sdxl_port_model,
    to_jax_model,
)

REL_TOL = 1e-4
STEPS, BATCH, RES, RANK, SEED = 3, 2, 32, 2, 4


def _close(out, ref, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: {err} of its max |ref|"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Six captioned JPEGs, non-square so that crops and flips draw."""
    return write_image_folder(str(tmp_path_factory.mktemp("data")), 6, (40, 48), seed=0)


def _args(mod, out, **kw):
    base = dict(train_batch_size=BATCH, rank=RANK, resolution=RES, max_train_steps=STEPS,
                learning_rate=1e-3, lr_scheduler="constant", lr_warmup_steps=0,
                mixed_precision="no", snr_gamma=5.0, noise_offset=0.05, seed=SEED,
                output_dir=str(out), log_every=1, report_to=None)
    base.update(kw)
    return mod(**base)


@pytest.mark.parametrize("bucketing", [False, True])
def test_dataset_batches_match_jax(data_dir, tmp_path, bucketing):
    for i, size in enumerate(((64, 32), (32, 64))):  # two more aspects for buckets
        write_image_folder(str(tmp_path), 1, size, seed=10 + i)
        os.rename(tmp_path / "img000.jpg", tmp_path / f"extra{i}.jpg")
        os.rename(tmp_path / "img000.txt", tmp_path / f"extra{i}.txt")
    for f in os.listdir(data_dir):
        shutil.copy(os.path.join(data_dir, f), tmp_path / f)
    kw = dict(resolution=RES, seed=3, aspect_ratio_bucketing=bucketing, bucket_step=16)
    jd, td = jdataset.SDLoRADataset(str(tmp_path), **kw), tdataset.SDLoRADataset(str(tmp_path), **kw)
    assert td.buckets == jd.buckets
    jit, tit = jd.batches(2, epochs=2), td.batches(2, epochs=2)
    n = 0
    for jb, tb in zip(jit, tit):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                np.testing.assert_array_equal(tb[k], jb[k])
            else:
                assert tb[k] == jb[k]
        n += 1
    assert n == (6 if bucketing else 8)  # buckets drop their incomplete batches
    assert next(tit, None) is None and next(jit, None) is None


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    """Three SDXL steps with text-encoder LoRA through the JAX trainer, and
    the port's trainer from the same initial factors and draws."""
    tm = tiny_sdxl_port_model(seed=1)
    jm = to_jax_model(tm)
    out = tmp_path_factory.mktemp("train")
    # Adam divides each gradient element by its magnitude plus eps, so at
    # the default eps 1e-8 an element far below its tensor's largest moves
    # the factor by ~lr whatever its last bits are: bigG's last-layer q/k
    # gradients (~1e-8, reached only through the pooled EOS row) came out
    # 0.2% apart between the two packages' fp32 summation orders and moved
    # their factors 5.7e-4 of lr apart after one step.  With eps 1e-4 above
    # the tiny model's gradients the update is ~lr * g / eps, and the
    # comparison holds the gradients that the trainer's data, draws,
    # tokenization and micro-conditioning give (AdamW itself is held in
    # tests/test_torch_train.py, the 8-bit moments in test_torch_optim_8bit.py)
    kw = dict(train_text_encoder=True, adam_epsilon=1e-4)
    jt = JTrainer(jm, _args(JArgs, out / "jax", **kw), data_dir)
    jlora = jax.tree_util.tree_map(np.asarray, jt.train())

    k_unet, k_te, k_te2, k_loop = jax.random.split(as_key(SEED), 4)
    initial = {
        comp: lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora_init))
        for comp, jlora_init in (
            ("unet", jlora_core.init_lora(k_unet, jm.unet_params, RANK,
                                     jlora_core.UNET_TARGET_SUFFIXES, store_alpha=False)),
            ("text_encoder", jlora_core.init_lora(k_te, jm.text_encoder_params, RANK,
                                             jlora_core.TEXT_TARGET_SUFFIXES, store_alpha=False)),
            ("text_encoder_2", jlora_core.init_lora(k_te2, jm.text_encoder_2_params, RANK,
                                               jlora_core.TEXT_TARGET_SUFFIXES, store_alpha=False)))}
    step_keys = []
    for _ in range(STEPS):
        k_loop, k_step = jax.random.split(k_loop)
        step_keys.append(k_step)
    draws = lambda step: _draws(step_keys[step], tm)  # noqa: E731
    targs = _args(SDTrainingArgs, out / "port", **kw)
    tt = SDLoRATrainer(tm, targs, data_dir, initial=initial, draws=draws)
    tlora = tt.train()
    return jt, jlora, tt, tlora, tm, jm, draws, initial


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


def test_trainer_matches_jax(trained):
    jt, jlora, tt, tlora, tm, _, _, initial = trained
    assert [s for s, _ in tt.history] == [s for s, _ in jt.history] == [1, 2, 3]
    for (_, a), (_, b) in zip(tt.history, jt.history):
        _close(a, b, "logged loss")
    assert sorted(tlora) == sorted(jlora) == ["text_encoder", "text_encoder_2", "unet"]
    # CLIP-L's last layer gets no gradient: its `up` factors stay zero
    last = f"text_model.encoder.layers.{tm.text_encoder_config.num_hidden_layers - 1}."
    for comp in tlora:
        for path, t in tree_leaves(tlora[comp]):
            ref = dict(tree_leaves(jlora[comp]))[path]
            _close(t.numpy(), ref, f"{comp}.{path}")
            dead = comp == "text_encoder" and path.startswith(last) and path.endswith("up")
            assert torch.equal(t, dict(tree_leaves(initial[comp]))[path]) == dead, path


@pytest.mark.parametrize("fmt", ["peft", "kohya"])
def test_saved_lora_loads_in_jax(trained, tmp_path, fmt):
    """The trainer's file (peft) and the same factors saved as kohya load in
    the JAX package with every tensor equal to the port's."""
    _, _, tt, tlora, _, jm, _, _ = trained
    path = f"{tt.args.output_dir}/pytorch_lora_weights.safetensors"
    if fmt == "kohya":
        from stablediffusion_tpu_torch.lora.formats import save_lora_file

        path = str(tmp_path / "kohya.safetensors")
        save_lora_file(tlora, path, metadata={"format": "pt", "rank": str(RANK)},
                       format="kohya")
    with SafetensorsFile(path) as f:
        assert f.metadata == {"format": "pt", "rank": str(RANK)}
    loaded = jax_load_lora_file(path, jm.lora_module_paths())
    assert sorted(loaded) == sorted(tlora)
    for comp, tree in tlora.items():
        assert sorted(loaded[comp]) == sorted(tree)
        for mpath, f in tree.items():
            for k in ("down", "up"):
                np.testing.assert_array_equal(np.asarray(loaded[comp][mpath][k]), f[k].numpy())


def _port_run(model, data_dir, out, **kw):
    args = _args(SDTrainingArgs, out, **kw)
    trainer = SDLoRATrainer(model, args, data_dir)
    return trainer, trainer.train()


def test_resumed_run_equals_straight_run(data_dir, tmp_path):
    """Four steps straight against one step, then a resume from its
    checkpoint for three more: the 8-bit codes (rank 128 makes the tiny
    UNet's 32-wide to_q/k/v/out factors 4096 elements), the bf16 accumulator half
    way through its two mini-steps, the generator and the data stream all
    come back, so the factors end bit for bit equal.  Rotation keeps the
    newest two checkpoints."""
    kw = dict(max_train_steps=4, rank=128, train_text_encoder=False, use_8bit_adam=True,
              gradient_accumulation_steps=2, accum_dtype="bf16", checkpointing_steps=1,
              lora_format="kohya")
    _, straight = _port_run(tiny_port_model(seed=2), data_dir, tmp_path / "a", **kw)
    with SafetensorsFile(str(tmp_path / "a" / "checkpoint-1" / ckpt.TENSORS)) as f:
        dtypes = {f.dtype_str(k) for k in f.keys() if k.startswith("opt_state/inner/mu/")}
        assert {"I8", "F32"} <= dtypes  # codes and scales, and small fp32 moments
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "checkpoint-1", tmp_path / "b" / "checkpoint-1")
    trainer, resumed = _port_run(tiny_port_model(seed=2), data_dir, tmp_path / "b",
                                 resume_from_checkpoint="latest", checkpoints_total_limit=2,
                                 **kw)
    assert [s for s, _ in trainer.history] == [2, 3, 4]
    assert sorted(os.listdir(tmp_path / "b")) == [
        "checkpoint-3", "checkpoint-4", "pytorch_lora_weights.safetensors"]
    for (p, a), (_, b) in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b), p
    state = ckpt.load_checkpoint(str(tmp_path / "b" / "checkpoint-4"), {
        "lora": resumed, "opt_state": trainer_state_template(resumed),
        "rng": torch.Generator().get_state()})
    assert state["opt_state"]["mini_step"] == 0 and state["opt_state"]["inner"]["count"] == 2


def trainer_state_template(lora):
    from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer

    opt = make_optimizer(make_lr_schedule("constant", 1e-3), grad_accum_steps=2,
                         use_8bit=True, accum_dtype="bf16")
    return opt.init(lora)


def test_cache_latents_equals_fused_path(trained, data_dir, tmp_path):
    """With the same initial factors and draws, the separate encode of
    cache_latents gives the fused step's factors bit for bit (the same ops
    in the same order, split in two calls)."""
    _, _, _, _, tm, _, draws, initial = trained
    runs = []
    for cache in (False, True):
        args = _args(SDTrainingArgs, tmp_path / str(cache), train_text_encoder=False,
                     cache_latents=cache)
        trainer = SDLoRATrainer(tm, args, data_dir, initial={"unet": initial["unet"]},
                                draws=draws)
        runs.append(trainer.train())
    for (p, a), (_, b) in zip(tree_leaves(runs[0]), tree_leaves(runs[1])):
        assert torch.equal(a, b), p
    with pytest.raises(ValueError, match="cache_latents"):
        SDLoRATrainer(tm, _args(SDTrainingArgs, tmp_path, cache_latents=True,
                                train_text_encoder=True), data_dir).train()


def test_cli_and_handler_train_mode(data_dir, tmp_path):
    """`cli.main` on a saved folder writes the adapter and the validation
    render; the handler's train mode answers with the history and the
    file's path."""
    folder = str(tmp_path / "model")
    save_sd_model(tiny_port_model(seed=5), folder)
    out = tmp_path / "cli-out"
    cli.main(["--pretrained_model_name_or_path", folder, "--model_type", "sd15",
              "--train_data_dir", data_dir, "--device", "cpu", "--resolution", str(RES),
              "--train_batch_size", "2", "--max_train_steps", "2", "--rank", "2",
              "--mixed_precision", "no", "--report_to", "none", "--checkpointing_steps", "2",
              "--validation_prompt", "a cat", "--num_validation_images", "1",
              "--output_dir", str(out), "--lora_format", "kohya"])
    assert os.path.exists(out / "pytorch_lora_weights.safetensors")
    assert os.path.exists(out / "checkpoint-2" / ckpt.SCALARS)
    assert os.path.exists(out / "validation" / "0.png")

    handler = Handler(model=tiny_port_model(seed=5))
    resp = handler({"mode": "train", "train": {
        "data_dir": data_dir, "output_dir": str(tmp_path / "h"), "resolution": RES,
        "train_batch_size": 2, "max_train_steps": 2, "rank": 2, "log_every": 1,
        "mixed_precision": "no", "report_to": None, "lr_warmup_steps": 0}})
    assert "error" not in resp, resp
    assert [s for s, _ in resp["history"]] == [1, 2]
    assert resp["lora_path"] == f"{tmp_path / 'h'}/pytorch_lora_weights.safetensors"
    assert os.path.exists(resp["lora_path"])


# the ids are those the cases had while item 19's options were refused too;
# the options are ported (test_torch_parallel.py) and, as in JAX, need a mesh
@pytest.mark.parametrize("kw, item", [
    pytest.param(dict(shard_opt_state=True), "pass a mesh", id="kw5-item 20"),
    pytest.param(dict(shard_params=True), "pass a mesh", id="kw6-item 20"),
])
def test_unported_options_raise(data_dir, tmp_path, kw, item):
    name = next(iter(kw))
    with pytest.raises(ValueError, match=f"{name}.*{item}"):
        _port_run(tiny_port_model(), data_dir, tmp_path, **kw)


@pytest.mark.parametrize("kw", [
    dict(textual_inversion="<x>", ti_initializer_token="cat", train_text_encoder=False),
    dict(instance_prompt="a photo of sks dog"),
    dict(with_prior_preservation=True, instance_prompt="a photo of sks dog",
         class_prompt="a photo of dog"),
    dict(full_finetune=True, train_text_encoder=False),
    dict(full_finetune=True, use_ema=True, train_text_encoder=False),
    dict(remat_policy="dots"),
    dict(remat_policy="offload"),
], ids=["textual_inversion", "instance_prompt", "with_prior_preservation", "full_finetune",
        "use_ema", "dots", "offload"])
def test_item19_options_train(data_dir, tmp_path, kw):
    """The options the trainer refused until ROADMAP item 19's port each
    train a step now."""
    if kw.get("with_prior_preservation"):
        kw = dict(kw, class_data_dir=data_dir)  # the folder's images as the class set
    trainer, _ = _port_run(tiny_port_model(), data_dir, tmp_path, max_train_steps=1, **kw)
    assert [s for s, _ in trainer.history] == [1] and np.isfinite(trainer.history[0][1])


# the ids are those the cases had while --push_to_hub and the TI flag were
# refused too.  The distributed flags are ported: --local_rank trains (one
# process outside torchrun), --shard_params needs a data mesh
@pytest.mark.parametrize("flags, item", [
    pytest.param(["--local_rank", "0"], None, id="flags1-item 20"),
    pytest.param(["--shard_params"], "need a data mesh", id="flags2-item 20"),
])
def test_cli_refuses_unported_flags(data_dir, tmp_path, flags, item):
    folder = str(tmp_path / "model")
    save_sd_model(tiny_port_model(), folder)
    argv = ["--pretrained_model_name_or_path", folder, "--train_data_dir", data_dir,
            "--device", "cpu", "--max_train_steps", "1", "--output_dir",
            str(tmp_path / "out"), "--resolution", str(RES), "--train_batch_size", "2",
            "--mixed_precision", "no", "--report_to", "none", *flags]
    if item is None:
        assert [s for s, _ in cli.main(argv).history] == [1]
        return
    with pytest.raises(ValueError, match=item):
        cli.main(argv)


class _FakeHub:
    """A huggingface_hub stand-in that records the calls (no network)."""

    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def create_repo(self, repo_id, exist_ok=False, token=None):
        self.calls.append(("create_repo", repo_id, exist_ok, token))
        if self.fail:
            raise ConnectionError("no network")
        return type("Repo", (), {"repo_id": f"user/{repo_id}"})()

    def upload_folder(self, **kw):
        self.calls.append(("upload_folder", kw))


def test_cli_writes_the_model_card_and_pushes(data_dir, tmp_path, monkeypatch):
    """After training the CLI writes README.md (the JAX CLI's card fields)
    and, with --push_to_hub, creates the repository and uploads the folder
    through huggingface_hub; a failing hub logs "hub upload skipped"."""
    import sys
    import types

    folder = str(tmp_path / "model")
    save_sd_model(tiny_port_model(seed=5), folder)
    hub = _FakeHub()
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        create_repo=hub.create_repo, upload_folder=hub.upload_folder))
    out = tmp_path / "out"
    cli.main(["--pretrained_model_name_or_path", folder, "--model_type", "sd15",
              "--train_data_dir", data_dir, "--device", "cpu", "--resolution", str(RES),
              "--train_batch_size", "2", "--max_train_steps", "2", "--rank", "2",
              "--mixed_precision", "no", "--report_to", "none", "--checkpointing_steps", "0",
              "--output_dir", str(out), "--push_to_hub", "--hub_model_id", "my-lora",
              "--hub_token", "t0k"])
    card = (out / "README.md").read_text()
    assert f"base_model: {folder}" in card and "- **steps**: 2" in card
    assert "- **rank**: 2" in card and "- **resolution**: 32" in card
    assert hub.calls[0] == ("create_repo", "my-lora", True, "t0k")
    assert hub.calls[1][1] == dict(repo_id="user/my-lora", folder_path=str(out),
                                   commit_message="LoRA trained with stablediffusion-tpu",
                                   ignore_patterns=["checkpoint-*", "logs*"], token="t0k")
    from stablediffusion_tpu_torch.train.model_card import push_to_hub

    failing = _FakeHub(fail=True)
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        create_repo=failing.create_repo, upload_folder=failing.upload_folder))
    assert push_to_hub(str(out), "x") is None and len(failing.calls) == 1


def test_model_card_matches_jax(tmp_path):
    """save_model_card writes JAX's card (front matter, images, training
    block), its usage snippet on the port's modules and a "cuda" tag in
    place of "tpu"; the sample images are the same files."""
    from stablediffusion_tpu.train.model_card import save_model_card as jax_card
    from stablediffusion_tpu_torch.train.model_card import save_model_card

    images = np.random.default_rng(0).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    info = {"rank": 4, "steps": 10, "snr_gamma": None}
    cards = {}
    for name, fn in (("jax", jax_card), ("port", save_model_card)):
        path = fn(str(tmp_path / name), "base/model", prompt="a cat", images=images,
                  train_info=info, repo_name="repo")
        cards[name] = open(path).read()
        assert sorted(os.listdir(tmp_path / name)) == ["README.md", "image_0.png", "image_1.png"]
    for i in range(2):
        assert (tmp_path / "jax" / f"image_{i}.png").read_bytes() == \
            (tmp_path / "port" / f"image_{i}.png").read_bytes()
    jlines, tlines = cards["jax"].splitlines(), cards["port"].splitlines()
    front = lambda lines: lines[:lines.index("---", 1) + 1]  # noqa: E731
    assert set(front(jlines)) ^ set(front(tlines)) == {"- tpu", "- cuda"}
    tail = lambda lines: lines[lines.index("## Training"):]  # noqa: E731
    assert tail(tlines) == tail(jlines)
    assert "from stablediffusion_tpu_torch.io.loader import load_sd_model" in cards["port"]
    assert "![img_1](./image_1.png)" in cards["port"]


def test_handler_full_finetune_answers_model_path(data_dir, tmp_path):
    """Under full_finetune the train mode answers the saved folder's path,
    as the JAX handler does (handler.py:523-526)."""
    handler = Handler(model=tiny_port_model(seed=5))
    out = str(tmp_path / "ff")
    resp = handler({"mode": "train", "train": {
        "data_dir": data_dir, "output_dir": out, "resolution": RES, "train_batch_size": 2,
        "max_train_steps": 1, "full_finetune": True, "train_text_encoder": False,
        "mixed_precision": "no", "report_to": None, "lr_warmup_steps": 0, "log_every": 1}})
    assert "error" not in resp, resp
    assert resp["model_path"] == out and "lora_path" not in resp
    assert os.path.exists(os.path.join(out, "unet")) and resp["history"][0][0] == 1


def test_mesh_refused():
    """A mesh is taken (a 1 x 1 one outside torchrun; the multi-process
    paths are test_torch_parallel.py's); sharded state without one is
    refused, as in JAX."""
    from stablediffusion_tpu_torch.parallel import make_mesh

    trainer = SDLoRATrainer(tiny_port_model(), SDTrainingArgs(report_to=None), "unused",
                            mesh=make_mesh())
    assert trainer.plan.mesh.shape == {"data": 1, "tensor": 1}
    with pytest.raises(ValueError, match="pass a mesh"):
        SDLoRATrainer(tiny_port_model(), SDTrainingArgs(shard_opt_state=True), "unused")


def test_trainer_defaults_match_jax():
    """Every field and default of SDTrainingArgs (trainer.py:43-142)."""
    jf = {f.name: f.default for f in dataclasses.fields(JArgs)}
    tf = {f.name: f.default for f in dataclasses.fields(SDTrainingArgs)}
    assert tf == jf
    assert cli.parse_args(["--pretrained_model_name_or_path", "x", "--train_data_dir", "y"]
                          ).__dict__.keys() - {"device"} == _jax_cli_flags()


def _jax_cli_flags():
    from stablediffusion_tpu.train import cli as jcli

    return set(jcli.parse_args(["--pretrained_model_name_or_path", "x",
                                "--train_data_dir", "y"]).__dict__)
