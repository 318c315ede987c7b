"""PyTorch/CUDA port: the 15 schedulers against the JAX package's, on the CPU.

Each case runs a whole plan on both sides from the same start: the model
output of step i is a fixed random array plus a tenth of the scaled sample
(each side its own sample, so the loop feeds back), and the stochastic steps
take the JAX draws, injected.  A scheduler whose tables drift by fp32
rounding shows only over a whole plan, so the trajectories are compared at
every step, within 1e-5 of the largest reference value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.core import config as jcfg
from stablediffusion_tpu.schedulers import SCHEDULER_NAMES as JNAMES
from stablediffusion_tpu.schedulers import make_scheduler as jmake
from stablediffusion_tpu_torch.core import config as tcfg
from stablediffusion_tpu_torch.schedulers import SCHEDULER_NAMES, make_scheduler
from stablediffusion_tpu_torch.schedulers.common import step_noise
from torch_port_helpers import port_test_module  # noqa: F401

SHAPE = (2, 8, 8, 4)
RTOL = 1e-5  # of max |ref| over the trajectory


def _run_both(name, steps=10, overrides=None, timesteps=None, sigmas=None, seed=0):
    """(port trajectory, JAX trajectory, port plan, JAX plan)."""
    overrides = overrides or {}
    js = jmake(name, dataclasses.replace(jcfg.SchedulerConfig(), **overrides))
    ts = make_scheduler(name, dataclasses.replace(tcfg.SchedulerConfig(), **overrides))
    jp = js.plan(steps, timesteps=timesteps, sigmas=sigmas)
    tp = ts.plan(steps, timesteps=timesteps, sigmas=sigmas)
    assert tp.num_steps == jp.num_steps and tp.order == jp.order
    assert ts.uses_noise() == js.uses_noise()
    r = np.random.default_rng(seed)
    x0 = r.standard_normal(SHAPE).astype(np.float32) * np.float32(jp.init_noise_sigma)
    outs = r.standard_normal((tp.num_steps,) + SHAPE).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), tp.num_steps)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstate = js.init_state(jp, SHAPE, jnp.float32)
    tstate = ts.init_state(tp, SHAPE)
    jtraj, ttraj = [], []
    for i in range(tp.num_steps):
        jout = jnp.asarray(outs[i]) + 0.1 * js.scale_model_input(jp, jx, i)
        tout = torch.from_numpy(outs[i]) + 0.1 * ts.scale_model_input(tp, tx, i)
        noise = None
        if ts.uses_noise():
            noise = torch.from_numpy(np.array(jax.random.normal(keys[i], SHAPE, jnp.float32)))
        jx, jstate = js.step(jp, jstate, i, jout, jx, key=keys[i])
        tx, tstate = ts.step(tp, tstate, i, tout, tx, noise=noise)
        jtraj.append(np.asarray(jx))
        ttraj.append(tx.numpy())
    return np.stack(ttraj), np.stack(jtraj), tp, jp


def _close(out, ref):
    err = np.abs(out - ref).max()
    assert err <= RTOL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_scheduler_names_equal_jax():
    assert SCHEDULER_NAMES == JNAMES


@pytest.mark.parametrize("name", JNAMES)
def test_whole_plan_matches_jax(name):
    out, ref, tp, jp = _run_both(name)
    np.testing.assert_allclose(tp.timesteps, np.asarray(jp.timesteps), rtol=1e-6)
    np.testing.assert_allclose(tp.sigmas, np.asarray(jp.sigmas), rtol=1e-6)
    assert np.isfinite(out).all()
    _close(out, ref)


@pytest.mark.parametrize("name, overrides", [
    ("euler", {"use_karras_sigmas": True}),
    ("DPM++ 2M", {"timestep_spacing": "trailing", "prediction_type": "v_prediction"}),
    ("uni_pc", {"solver_type": "bh1", "final_sigmas_type": "sigma_min"}),
    ("DPM++ 3M SDE", {"timestep_spacing": "linspace"}),
])
def test_config_variants_match_jax(name, overrides):
    out, ref, _, _ = _run_both(name, steps=16, overrides=overrides, seed=1)
    _close(out, ref)


@pytest.mark.parametrize("name, kw", [
    ("DDIM", {"timesteps": [999, 800, 650, 400, 200, 50]}),
    ("euler_a", {"sigmas": [14.0, 8.0, 3.5, 1.2, 0.4, 0.05]}),
    ("DPM++ 2M", {"sigmas": [12.0, 6.0, 2.0, 0.7, 0.1]}),
    ("uni_pc", {"timesteps": [950, 700, 450, 200, 20]}),
    ("heun", {"timesteps": [900, 600, 300, 100]}),
])
def test_custom_schedules_match_jax(name, kw):
    n = len(next(iter(kw.values())))
    out, ref, _, _ = _run_both(name, steps=n, **kw)
    _close(out, ref)


def test_custom_schedule_rules():
    with pytest.raises(ValueError, match="only one"):
        make_scheduler("euler").plan(4, timesteps=[900, 500], sigmas=[3.0, 1.0])
    with pytest.raises(ValueError, match="karras"):
        make_scheduler("DPM++ 2M Karras").plan(2, timesteps=[900, 500])
    with pytest.raises(ValueError, match="sigmas"):
        make_scheduler("DDIM").plan(2, sigmas=[3.0, 1.0])


@pytest.mark.parametrize("name", ["DDIM", "euler", "DPM++ 2M", "uni_pc", "PNDM",
                                  "FlowMatchEuler", "LCM"])
def test_add_noise_index_matches_jax(name):
    js, ts = jmake(name), make_scheduler(name)
    jp, tp = js.plan(10), ts.plan(10)
    r = np.random.default_rng(2)
    x, n = (r.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    for i in (0, 4):
        ref = js.add_noise_index(jp, jnp.asarray(x), jnp.asarray(n), i)
        out = ts.add_noise_index(tp, torch.from_numpy(x), torch.from_numpy(n), i)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_stochastic_steps_need_noise():
    ts = make_scheduler("euler_a")
    tp = ts.plan(4)
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="noise"):
        ts.step(tp, (), 0, x, x)


def test_step_noise_per_sample_streams():
    """One generator per sample: a sample's noise does not depend on the
    other samples of its batch."""
    like = torch.zeros(3, 4, 2, 2)
    gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]  # noqa: E731
    a = step_noise(gens([7, 8, 9]), like)
    b = step_noise(gens([1, 8, 2]), like)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[0], b[0])
    assert step_noise(torch.Generator().manual_seed(0), like).shape == like.shape
