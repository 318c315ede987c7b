"""Multi-process dry run of the parallel paths on the CPU.

The counterpart of ``__graft_entry__.dryrun_multichip`` (which runs the JAX
package over a virtual CPU mesh): :func:`dryrun_multichip` spawns `n`
processes, joins them in a gloo process group over ``tcp://localhost``,
and runs on tiny fp32 models:

  * one full train step each under DP (LoRA on the UNet and the text
    tower), DP + ZeRO-1 and DP + FSDP (whole-UNet fine-tuning, FSDP with
    ZeRO-1 as JAX's dry run pairs them; again with 8-bit Adam, whose
    moments stay whole) on a data x 1 mesh, and under tensor = 2 (LoRA and
    whole-UNet) on a data/2 x 2 mesh;
  * the DP LoRA step again with the generator's own draws (no injected
    ones), to hold against a 1-rank run;
  * a tensor = 2 UNet and MM-DiT forward against the whole forward;
  * a ``Handler(mesh=...)`` render of a merged call of `n` rows on the data
    mesh (rank 0 gathers them), and the :func:`handler_requests` through
    ``Handler.__call__`` on rank 0 while the other ranks run
    ``Handler.follow``.

Rank 0 returns {case: result}: each step's trainable tree before and after
(whole, gathered) with its loss and grad norm, the forwards' outputs, the
render's images, the requests' answers.  The global batch and the injected draws come from
`inputs` (a ``torch.save`` file: {"batch", "draws"}, NCHW draws of the
whole batch), else from a numpy seed; the tiny models from
:func:`tiny_model` / :func:`tiny_sd3_model`, which a caller rebuilds
bit for bit in its own process.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from stablediffusion_tpu_torch.core import config as cfg

STEP_LR = 1e-3
STEP_EPS = 1e-2  # Adam's eps at the tiny gradients' scale: updates follow them smoothly
LORA_RANK = 2


def tiny_tokenizer():
    """A character-level tokenizer within the tiny CLIP's 1000 ids (bos 998,
    eos 999)."""
    from stablediffusion_tpu_torch.tokenizer.clip_bpe import CLIPTokenizer

    chars = "abcdefghijklmnopqrstuvwxyz0123456789 .,!?'-"
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = 998
    vocab["<|endoftext|>"] = 999
    return CLIPTokenizer(vocab, [])


def _init(module: torch.nn.Module, g: torch.Generator) -> torch.nn.Module:
    """Linears at std fan_in^-0.5, convolutions at 0.3 of it, norm scales
    1 + N(0, 0.02), biases N(0, 0.02)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.normal_(0.0, 0.02, generator=g)
                if name.endswith("weight"):
                    p.add_(1.0)
            else:
                fan_in = p.shape[0] if name.endswith("embedding.weight") else p[0].numel()
                p.normal_(0.0, (0.3 if p.dim() == 4 else 1.0) * fan_in**-0.5, generator=g)
    return module.eval().requires_grad_(False)


def tiny_model(seed: int = 0):
    """The tiny SD1.5-layout model of the dry run, fp32 on the CPU."""
    from stablediffusion_tpu_torch.models.clip import CLIPTextModel
    from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
    from stablediffusion_tpu_torch.models.vae import AutoencoderKL
    from stablediffusion_tpu_torch.models.wrapper import SDModel

    g = torch.Generator().manual_seed(seed)
    uc = cfg.tiny_unet_config()
    vc, cc = cfg.tiny_vae_config(), cfg.tiny_clip_config()
    return SDModel(unet_config=uc, unet=_init(UNet2DConditionModel(uc), g),
                   vae_config=vc, vae=_init(AutoencoderKL(vc), g),
                   text_encoder_config=cc, text_encoder=_init(CLIPTextModel(cc), g),
                   tokenizer=tiny_tokenizer())


def tiny_sd3_model(seed: int = 0):
    """The tiny MM-DiT of the dry run (2 heads), fp32 on the CPU."""
    from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel

    g = torch.Generator().manual_seed(seed)
    tf = cfg.tiny_sd3_config()
    return tf, _init(SD3Transformer2DModel(tf), g)


def make_inputs(batch_size: int, res: int = 32, seed: int = 0) -> Dict[str, Any]:
    """A global batch (NHWC pixels in [-1, 1], token ids) from a numpy seed."""
    r = np.random.default_rng(seed)
    return {"batch": {
        "pixel_values": torch.from_numpy(r.uniform(-1, 1, (batch_size, res, res, 3))
                                         .astype(np.float32)),
        "input_ids": torch.from_numpy(r.integers(0, 90, (batch_size, 77))).long()}}


def statics_for(model, full: bool):
    from stablediffusion_tpu_torch.train.train_step import TrainStatics

    return TrainStatics(
        unet_config=model.unet_config, vae_config=model.vae_config,
        text_config=model.text_encoder_config, text_config_2=None,
        scheduler_config=model.scheduler_config, train_text_encoder=not full,
        snr_gamma=5.0, compute_dtype=torch.float32)


def initial_trainable(model, full: bool):
    """The step's trainable tree: the UNet's fp32 masters, or seeded LoRA
    factors on the UNet and the text tower (their "up" drawn too, so that
    the step's gradients reach every factor)."""
    from stablediffusion_tpu_torch.lora.core import (
        TEXT_TARGET_SUFFIXES,
        UNET_TARGET_SUFFIXES,
        init_lora,
    )

    if full:
        return {n: p.detach().float().clone() for n, p in model.unet.named_parameters()}
    g = torch.Generator(next(model.unet.parameters()).device).manual_seed(1)
    tree = {"unet": init_lora(model.unet, LORA_RANK, UNET_TARGET_SUFFIXES, g,
                              store_alpha=False),
            "text_encoder": init_lora(model.text_encoder, LORA_RANK, TEXT_TARGET_SUFFIXES, g,
                                      store_alpha=False)}
    for comp in tree.values():
        for f in comp.values():
            f["up"].normal_(0.0, 0.02, generator=g)
    return tree


def _optimizer(use_8bit: bool = False):
    from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer

    return make_optimizer(make_lr_schedule("constant", STEP_LR), adam_eps=STEP_EPS,
                          use_8bit=use_8bit)


def run_step(model, mesh, full: bool, batch, draws=None, zero1: bool = False,
             fsdp: bool = False, seed: int = 0, use_8bit: bool = False) -> Dict[str, Any]:
    """One train step of the dry run's model on this rank's rows of `batch`
    (the global batch); returns the trainable tree before and after (whole),
    the loss and the grad norm, and under FSDP the most bytes of whole
    copies alive at once (``zero.gather_stats``) beside the bytes of the
    whole UNet, of its largest block and of the rest outside its blocks,
    and of the modules held whole for the step."""
    from stablediffusion_tpu_torch.parallel import shard_batch, zero
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.optim import tree_leaves
    from stablediffusion_tpu_torch.train.train_step import (
        full_finetune_loss_fn,
        loss_fn,
        make_train_step,
    )

    statics = statics_for(model, full)
    opt = _optimizer(use_8bit)
    if zero1:
        opt = zero.ZeroOptimizer(opt, mesh)
    trainable = initial_trainable(model, full)
    before = {p: t.clone() for p, t in tree_leaves(trainable)}
    state = opt.init(trainable)
    frozen = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder}
    if fsdp:
        zero.shard_modules_(frozen.values(), mesh)
        trainable = zero.shard_tree(trainable, mesh)
    step = make_train_step(statics, DDPMScheduler(statics.scheduler_config), opt,
                           loss=full_finetune_loss_fn if full else loss_fn, mesh=mesh,
                           shard_params=fsdp)
    local = shard_batch(mesh, batch) if mesh is not None else batch
    gen = torch.Generator(next(model.unet.parameters()).device).manual_seed(seed)
    zero.reset_gather_stats()
    held = zero.gather_stats()["live"]
    trainable, state, metrics = step(trainable, state, frozen, local, gen, draws=draws)
    out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "gathered_peak_bytes": zero.gather_stats()["peak"] - held}
    if fsdp:
        zero.unshard_modules_(frozen.values())
        trainable = zero.gather_tree(trainable)
        # the whole copies' most bytes at once, beside the whole modules'
        from stablediffusion_tpu_torch.train.train_step import REMAT_UNITS

        size = lambda m: sum(p.numel() * p.element_size() for p in m.parameters())  # noqa: E731
        units = [size(m) for m in model.unet.modules() if isinstance(m, REMAT_UNITS)]
        out.update(unet_bytes=size(model.unet), unit_bytes_max=max(units),
                   root_bytes=size(model.unet) - sum(units),
                   span_bytes=size(model.vae) + size(model.text_encoder))
    return {"before": before, "after": {p: t.clone() for p, t in tree_leaves(trainable)}, **out}


def unet_inputs(model, B: int = 2, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    c = model.unet_config
    return (torch.randn(B, c.in_channels, 8, 8, generator=g), torch.tensor([500] * B),
            torch.randn(B, 77, c.cross_attention_dim, generator=g))


def sd3_inputs(tf_cfg, B: int = 2, seed: int = 4):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, tf_cfg.in_channels, 8, 8, generator=g),
            torch.randn(B, 12, tf_cfg.joint_attention_dim, generator=g),
            torch.randn(B, tf_cfg.pooled_projection_dim, generator=g), torch.tensor([500.0] * B))


RENDER_ARGS = dict(num_inference_steps=2, height=32, width=32, guidance_scale=5.0)


def render_args(n: int) -> Dict[str, Any]:
    """A merged call of `n` rows, as the batcher builds one."""
    return dict(RENDER_ARGS, prompt=[f"a cat {i}" for i in range(n)],
                negative_prompt=[""] * n, seed=[11 + i for i in range(n)])


def handler_requests(n: int):
    """Requests through ``Handler.__call__``: a merged one of `n` rows (split
    over ``data``), a single prompt (whole on every rank), and one that
    fails on every rank."""
    return [dict(RENDER_ARGS, prompt=[f"a dog {i}" for i in range(n)], negative_prompt=[""] * n,
                 seed=[21 + i for i in range(n)]),
            dict(RENDER_ARGS, prompt="a cat", seed=5),
            dict(RENDER_ARGS, prompt="a cat", seed=5, mode="no such mode")]


def _worker(rank: int, world: int, port: int, inputs_path: Optional[str], out_path: str):
    import torch.distributed as dist

    from stablediffusion_tpu_torch.parallel import make_mesh, tp
    from stablediffusion_tpu_torch.serve.handler import Handler

    torch.set_num_threads(1)
    # a collective that finds no partner fails after the timeout, not never
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        data_mesh = make_mesh(data=world, tensor=1)
        tp_mesh = make_mesh(data=world // 2, tensor=2)
        inputs = (torch.load(inputs_path, weights_only=True) if inputs_path
                  else make_inputs(2 * world))
        batch, draws = inputs["batch"], inputs.get("draws")
        res: Dict[str, Any] = {}
        cases = {"dp": (data_mesh, False, {}), "zero1": (data_mesh, True, dict(zero1=True)),
                 "fsdp": (data_mesh, True, dict(zero1=True, fsdp=True)),
                 "fsdp_8bit": (data_mesh, True, dict(zero1=True, fsdp=True, use_8bit=True)),
                 "tp2_lora": (tp_mesh, False, {}), "tp2_full": (tp_mesh, True, {})}
        for name, (mesh, full, kw) in cases.items():
            res[name] = run_step(tiny_model(), mesh, full, batch, draws, **kw)
        res["dp_own_draws"] = run_step(tiny_model(), data_mesh, False, batch, None)

        model = tiny_model()
        args = unet_inputs(model)
        with torch.no_grad():
            whole = model.unet(*args)
            with tp.parallel([model.unet], tp_mesh):
                split = model.unet(*args)
            tf_cfg, mmdit = tiny_sd3_model()
            x, ctx, pooled, t = sd3_inputs(tf_cfg)
            whole_3 = mmdit(x, t, ctx, pooled)
            with tp.parallel([mmdit], tp_mesh):
                split_3 = mmdit(x, t, ctx, pooled)
        res["tp2_unet"] = {"whole": whole, "split": split}
        res["tp2_mmdit"] = {"whole": whole_3, "split": split_3}

        handler = Handler(model=tiny_model(), mesh=data_mesh)
        with handler.lockstep():  # every rank makes the same call here
            out = handler._generate(render_args(world), output_type="np")
        res["handler_dp"] = {"images": np.asarray(out.images), "seed": out.seed}
        # requests as the worker serves them: rank 0 calls, the others follow
        if rank == 0:
            res["handler_requests"] = [handler(dict(r)) for r in handler_requests(world)]
            handler.stop_followers()
        else:
            handler.follow()
        if rank == 0:
            torch.save(res, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int = 2, inputs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run the dry run over `n` (even) gloo processes; returns rank 0's
    results (see the module docstring)."""
    import torch.multiprocessing as mp

    assert n % 2 == 0, "the tensor = 2 cases need an even process count"
    with tempfile.TemporaryDirectory() as tmp:
        inputs_path = None
        if inputs is not None:
            inputs_path = os.path.join(tmp, "inputs.pt")
            torch.save(inputs, inputs_path)
        out_path = os.path.join(tmp, "results.pt")
        mp.start_processes(_worker, args=(n, _free_port(), inputs_path, out_path), nprocs=n,
                           join=True, start_method="spawn")
        return torch.load(out_path, weights_only=False)


if __name__ == "__main__":
    import sys

    results = dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
    print({k: (v.get("loss"), v.get("grad_norm")) for k, v in results.items() if "loss" in v})
