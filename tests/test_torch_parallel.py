"""PyTorch/CUDA port: parallelism over torch.distributed against the JAX
package's single-device step, on the CPU.

One ``parallel.dryrun.dryrun_multichip(2)`` spawn (two gloo processes)
runs a train step under DP (LoRA on the UNet and the text tower), DP +
ZeRO-1, DP + FSDP (whole-UNet fine-tuning) and tensor = 2 (both), a
tensor = 2 UNet and MM-DiT forward, a ``Handler(mesh=...)`` render, and
requests through rank 0's ``Handler.__call__`` while rank 1 follows.
Each step is held against JAX's ``make_train_step`` on the whole global
batch (the JAX step's draws injected as the global batch's; each rank
takes its rows) within REL_TOL of each leaf's largest value; the DP step
with the generator's own draws against a 1-rank port run; FSDP's whole
copies against its per-block bound; the split forwards, the split render
and the requests against the whole ones (the answers exactly).
In-process: the GEGLU row permutation, the local head count, the leaf and
suffix rules against JAX's ``_best_axis`` and ``_spec_for``, FSDP's
refusals and its slices through a checkpoint.  REL_TOL = 1e-5: the
ranks' sums (the gradients' mean, the row-parallel products) change fp32
summation orders only.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.parallel import tp as jtp
from stablediffusion_tpu.parallel import zero as jzero
from stablediffusion_tpu.schedulers import DDPMScheduler as JDDPM
from stablediffusion_tpu.train import optim as joptim
from stablediffusion_tpu.train import train_step as jts
from stablediffusion_tpu_torch.io.from_jax import flatten, to_torch_layout
from stablediffusion_tpu_torch.models.unet import GEGLU, Attention
from stablediffusion_tpu_torch.parallel import dryrun, make_mesh, tp, zero
from stablediffusion_tpu_torch.parallel.mesh import Mesh, rows, shard_batch
from stablediffusion_tpu_torch.serve.handler import Handler
from stablediffusion_tpu_torch.train.optim import tree_leaves
from torch_port_helpers import jax_tree, port_test_module, to_jax_model  # noqa: F401

REL_TOL = 1e-5
B, RES = 4, 32  # the global batch: two rows per data rank
STEP_CASES = {"dp": False, "zero1": True, "fsdp": True, "tp2_lora": False, "tp2_full": True}


def _close(out, ref, what, tol=REL_TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, f"{what}: {err} of its max |ref|"


def _draws(key, model):
    """The JAX step's draws for `key` (train_step.py:157-190), NCHW, for the
    whole batch."""
    k_sample, k_noise, k_t, _ = jax.random.split(key, 4)
    h = RES // model.vae_scale_factor
    shape = (B, h, h, model.vae_config.latent_channels)
    nchw = lambda a: torch.from_numpy(np.array(a).transpose(0, 3, 1, 2))  # noqa: E731
    return {"latent_eps": nchw(jax.random.normal(k_sample, shape, jnp.float32)),
            "noise": nchw(jax.random.normal(k_noise, shape, jnp.float32)),
            "timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, 1000)))}


def _jax_step(jm, trainable, full, batch, key):
    """JAX's single-device step on the whole batch; the trainable tree after."""
    st = jts.TrainStatics(
        unet_config=jm.unet_config, vae_config=jm.vae_config,
        text_config=jm.text_encoder_config, text_config_2=None,
        scheduler_config=jm.scheduler_config, train_text_encoder=not full, snr_gamma=5.0,
        compute_dtype=jnp.float32)
    opt = joptim.make_optimizer(joptim.make_lr_schedule("constant", dryrun.STEP_LR),
                                adam_eps=dryrun.STEP_EPS)
    frozen = {"unet": jm.unet_params, "vae": jm.vae_params,
              "text_encoder": jm.text_encoder_params}
    loss = jts.full_finetune_loss_fn if full else jts.loss_fn
    if full:
        frozen = {k: v for k, v in frozen.items() if k != "unet"}
    step = jts.make_train_step(st, JDDPM(st.scheduler_config), opt, loss=loss)
    jbatch = {"pixel_values": jnp.asarray(batch["pixel_values"].numpy()),
              "input_ids": jnp.asarray(batch["input_ids"].numpy().astype(np.int32))}
    after, _, m = step(trainable, opt.init(trainable), frozen, jbatch, key)
    return jax.tree_util.tree_map(np.asarray, after), float(m["loss"]), float(m["grad_norm"])


@pytest.fixture(scope="module")
def spawned():
    """The spawn's results, and JAX's two steps (LoRA, whole UNet) from the
    same initial trees, batch and draws.  The spawn's two processes run
    while this one takes the JAX steps: the LoRA step starts from the
    seeded factors of ``dryrun.initial_trainable``, which the spawn's DP
    step must start from too (held bit for bit)."""
    tm = dryrun.tiny_model()
    jm = to_jax_model(tm)
    key = jax.random.key(7)
    inputs = dryrun.make_inputs(B, RES)
    inputs["draws"] = _draws(key, tm)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(dryrun.dryrun_multichip, 2, inputs)
        lora0 = dict(tree_leaves(dryrun.initial_trainable(tm, False)))
        jlora = {}
        for p, t in lora0.items():
            comp, path, name = p.split(".", 1)[0], p.split(".", 1)[1].rsplit(".", 1)[0], \
                p.rsplit(".", 1)[1]
            jlora.setdefault(comp, {}).setdefault(path, {})[name] = jnp.asarray(t.numpy())
        ref_lora = _jax_step(jm, jlora, False, inputs["batch"], key)
        ref_full = _jax_step(jm, jm.unet_params, True, inputs["batch"], key)
        res = spawn.result()
    before = res["dp"]["before"]
    assert sorted(before) == sorted(lora0)
    assert all(torch.equal(before[p], t) for p, t in lora0.items())
    flat_lora = {f"{c}.{p}.{n}": a for c, tree in ref_lora[0].items()
                 for p, f in tree.items() for n, a in f.items()}
    flat_full = {k: to_torch_layout(k, a) for k, a in flatten(ref_full[0]).items()}
    return res, {False: (flat_lora, *ref_lora[1:]), True: (flat_full, *ref_full[1:])}, inputs


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax_single_device(spawned, case):
    """DP, DP + ZeRO-1, DP + FSDP and tensor = 2 over two processes: loss,
    grad norm (the clip acts in the whole-UNet cases) and every trainable
    leaf after the step, against JAX's step on the whole batch."""
    res, refs, _ = spawned
    ref, loss, gnorm = refs[STEP_CASES[case]]
    out = res[case]
    _close(out["loss"], loss, f"{case} loss")
    _close(out["grad_norm"], gnorm, f"{case} grad norm")
    assert sorted(out["after"]) == sorted(ref)
    for p, t in out["after"].items():
        assert not torch.equal(t, out["before"][p]), f"{case} {p} did not move"
        _close(t.numpy(), ref[p], f"{case} {p}")


def test_fsdp_with_8bit_adam_matches_one_rank(spawned):
    """FSDP's slices under 8-bit Adam, whose block-quantized moments stay
    whole: the 2-rank step against a 1-rank 8-bit step on the same batch and
    draws (within REL_TOL)."""
    res, _, inputs = spawned
    one = dryrun.run_step(dryrun.tiny_model(), None, True, inputs["batch"], inputs["draws"],
                          use_8bit=True)
    two = res["fsdp_8bit"]
    _close(two["loss"], one["loss"], "loss")
    _close(two["grad_norm"], one["grad_norm"], "grad norm")
    for p, t in two["after"].items():
        _close(t.numpy(), one["after"][p].numpy(), p)


def test_fsdp_holds_one_block_whole_at_a_time(spawned):
    """FSDP's whole copies during the step: the text tower and the VAE, the
    UNet's weights outside its blocks, and one block's; never the whole
    UNet."""
    r = spawned[0]["fsdp"]
    held = r["span_bytes"] + r["root_bytes"]
    assert held < r["gathered_peak_bytes"] <= held + r["unit_bytes_max"], r
    assert r["gathered_peak_bytes"] < r["span_bytes"] + r["unet_bytes"], r


def test_two_ranks_equal_one_rank_without_injected_draws(spawned):
    """The draws do not depend on the world size: the 2-rank DP step with
    the generator's own draws equals a 1-rank port step on the same global
    batch and seed."""
    res, _, inputs = spawned
    one = dryrun.run_step(dryrun.tiny_model(), None, False, inputs["batch"])
    two = res["dp_own_draws"]
    _close(two["loss"], one["loss"], "loss")
    for p, t in two["after"].items():
        _close(t.numpy(), one["after"][p].numpy(), p)
    # and differs from the injected draws' step: the draws are the generator's
    assert abs(two["loss"] - res["dp"]["loss"]) > 1e-6


@pytest.mark.parametrize("net", ["tp2_unet", "tp2_mmdit"])
def test_tensor_parallel_forward_matches_whole(spawned, net):
    out = spawned[0][net]
    _close(out["split"].numpy(), out["whole"].numpy(), net)


def test_handler_mesh_dp_render_matches_meshless(spawned):
    """A merged call of two rows over a data = 2 handler: each rank renders
    one row, rank 0 gathers them in order; against the meshless handler."""
    out = spawned[0]["handler_dp"]
    ref = Handler(model=dryrun.tiny_model())._generate(dryrun.render_args(2), output_type="np")
    assert out["seed"] == ref.seed
    _close(out["images"], np.asarray(ref.images), "images")


@pytest.mark.parametrize("i", range(3))
def test_handler_requests_through_the_follower_loop(spawned, i):
    """Requests through ``Handler.__call__`` on rank 0 while rank 1 runs
    ``follow``: each is sent once, rank 0 answers as the meshless handler
    does (the merged one split over ``data``), and a failing one answers on
    the error channel without stalling the ranks."""
    out = spawned[0]["handler_requests"][i]
    ref = Handler(model=dryrun.tiny_model())(
        dict(dryrun.handler_requests(2)[i]))
    assert ("error" in out) == ("error" in ref)
    if "error" in ref:
        assert out["error"] == ref["error"]
        return
    assert out["seed"] == ref["seed"]
    assert out["images"] == ref["images"]


def _fake_rank(i, tensor=2):
    """A mesh that sees itself at tensor index `i` with no process group:
    its collectives return their input, so a test can add the ranks'
    partial products itself."""
    mesh = Mesh(1, tensor)
    mesh.tensor_index = i
    return mesh


@pytest.mark.parametrize("tensor,zero1,match", [(1, False, "ZeroOptimizer"),
                                                 (2, True, "tensor > 1")])
def test_fsdp_refusals(tensor, zero1, match):
    """FSDP updates split masters (it needs the ZeRO optimizer) over the
    data axis alone."""
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.train_step import make_train_step

    mesh = Mesh(1, tensor)
    opt = dryrun._optimizer()
    statics = dryrun.statics_for(dryrun.tiny_model(), True)
    with pytest.raises(ValueError, match=match):
        make_train_step(statics, DDPMScheduler(statics.scheduler_config),
                        zero.ZeroOptimizer(opt, mesh) if zero1 else opt, mesh=mesh,
                        shard_params=True)


def test_checkpoint_keeps_fsdp_slices_split(tmp_path):
    """A resumed FSDP run's slices load tagged as split, so that the
    trainer's saves gather them whole again."""
    from stablediffusion_tpu_torch.train import checkpoint as ckpt

    mesh = Mesh(1, 1)
    mesh.groups = {"data": object(), "tensor": None}  # a data group: the leaf rule splits
    tree = zero.shard_tree({"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(3)}, mesh)
    assert zero.is_split(tree["w"])
    path = ckpt.save_checkpoint(str(tmp_path), 1, {"t": tree})
    back = ckpt.load_checkpoint(path, {"t": tree})["t"]
    assert zero.is_split(back["w"]) and zero.is_split(back["b"])
    assert torch.equal(back["w"], tree["w"])


def test_geglu_rows_are_matching_halves():
    """A rank's GEGLU projection holds hidden features r and the gates of
    the same features: the ranks' outputs, concatenated, are the whole."""
    torch.manual_seed(0)
    g = GEGLU(8, 12)
    x = torch.randn(3, 5, 8)
    whole = g(x)
    parts = []
    for i in range(2):
        r = tp._rows(24, _fake_rank(i), geglu=True)
        assert torch.equal(torch.as_tensor(r)[6:] - 12, torch.as_tensor(r)[:6])
        g.proj._tp = tp.TPLinear("col", _fake_rank(i), geglu=True)
        parts.append(g(x))
        del g.proj._tp
    torch.testing.assert_close(torch.cat(parts, -1), whole, rtol=0, atol=1e-6)
    # a contiguous split would pair rank 0's hidden features with rank 0's
    # hidden features again, not with their gates
    g.proj._tp = tp.TPLinear("col", _fake_rank(0), geglu=False)
    assert not torch.allclose(g(x), parts[0])


def test_local_head_count():
    """Under tensor = 2 a rank's attention runs heads / 2 heads over its
    q/k/v columns; the row-parallel to_out's partial products add to the
    whole output."""
    torch.manual_seed(1)
    att = Attention(16, 12, heads=4).eval()
    x, ctx = torch.randn(2, 6, 16), torch.randn(2, 3, 12)
    whole = att(x, ctx)
    bias = att.to_out[0].bias
    total = torch.zeros_like(whole)
    for i in range(2):
        for name, kind in (("to_q", "col"), ("to_k", "col"), ("to_v", "col")):
            getattr(att, name)._tp = tp.TPLinear(kind, _fake_rank(i))
        att.to_out[0]._tp = tp.TPLinear("row", _fake_rank(i))
        assert att.to_q._tp(att.to_q, x).shape[-1] // (16 // 4) == 2  # heads / tensor
        total += att(x, ctx) - bias
        tp.unparallelize(att)
    torch.testing.assert_close(total + bias, whole, rtol=0, atol=1e-6)


def test_leaf_and_suffix_rules_match_jax():
    """`_best_axis` on shapes of every kind of leaf, and the column/row rule
    on every 2-D weight of the tiny UNet and MM-DiT (torch [out, in]
    against JAX's [in, out] kernels), at tensor 2."""
    for shape in [(320, 320, 3, 3), (4,), (), (1280, 320), (77, 768), (6, 6), (3, 5), (8, 2, 2)]:
        for n in (1, 2, 4):
            assert zero._best_axis(shape, n) == jzero._best_axis(shape, n), (shape, n)
    tm = dryrun.tiny_model()
    _, mmdit = dryrun.tiny_sd3_model()
    for module in (tm.unet, mmdit):
        jflat = flatten(jax_tree(module))
        for name, p in module.named_parameters():
            if p.dim() != 2:
                continue
            spec = jtp._spec_for(name, 2, 2, jflat[name].shape)  # the same names
            want = {(None, "tensor"): "col", ("tensor", None): "row"}.get(tuple(spec))
            assert tp.spec_for(name, tuple(p.shape), 2) == want, name


def test_mesh_rules_without_a_process_group():
    """JAX's -1 rule and asserts; a 1 x 1 mesh has no groups, every row of
    a batch, and identity collectives."""
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "tensor": 1} and mesh.groups["data"] is None
    with pytest.raises(AssertionError, match="2x1"):
        make_mesh(data=2)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(shard_batch(mesh, {"x": x})["x"], x)
    assert torch.equal(mesh.all_gather(x, "data"), x)
    two = Mesh(2, 1)
    two.data_index = 1
    assert rows(two, 4) == slice(1, None, 2) and rows(two, 3) == slice(None)
    assert torch.equal(shard_batch(two, {"x": torch.arange(4)})["x"], torch.tensor([1, 3]))
