"""The port's few-step samplers against the JAX package's on the CPU: DDIM,
DPM-Solver++(2M) and its SDE form, first with a cheap analytic denoiser (the
loops' own arithmetic), then through the whole validation step with a toy
`dropout: 0` model (folded head) on the same weights.

The JAX side's noise is drawn first with its own keys (one split for the
initial image, one per step) and those arrays are injected into the port.
Tolerance: 1e-4 abs on images in about [-2, 2] after the loop, float32 on
both sides; the loops' scalar coefficients come from the same float32
schedule buffers.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucdir_tpu.diffusion.dpm_solver import dpm_solver_pp_sample as jax_dpm
from ucdir_tpu.diffusion.sampler import ddim_sample as jax_ddim
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train.step import make_eval_step
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
from ucdir_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_sample
from ucdir_tpu_torch.diffusion.sampler import ddim_sample
from ucdir_tpu_torch.eval import eval_step
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.trainer import Trainer

torch.set_num_threads(2)

ATOL = 1e-4
SCHED = dict(SID_VAL_SCHEDULE, n_timestep=12)
SHAPE = (2, 8, 10, 3)


def jax_draws(key, shape, steps, per_step=True):
    """The draws of the JAX samplers for `key`: the initial image, then (with
    per_step) one per step."""
    key, k0 = jax.random.split(key)
    draws = [np.array(jax.random.normal(k0, shape, np.float32))]
    for _ in range(steps):
        key, k = jax.random.split(key)
        if per_step:
            draws.append(np.array(jax.random.normal(k, shape, np.float32)))
    return draws


def injector(draws):
    it = iter(draws)
    return lambda shape: torch.from_numpy(next(it))


def toy_denoisers(cond):
    """The same smooth eps prediction on both sides."""
    def jd(img, nl):
        return jnp.tanh(0.7 * img + cond) * nl[:, :, None, None] + 0.1 * img

    def td(img, nl):
        return torch.tanh(0.7 * img + torch.from_numpy(cond)) \
            * nl[:, :, None, None] + 0.1 * img
    return jd, td


@pytest.mark.parametrize('steps', [3, 5])
@pytest.mark.parametrize('eta', [0.0, 1.0])
def test_ddim_sample_matches_jax(rng, steps, eta):
    cond = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    jd, td = toy_denoisers(cond)
    key = jax.random.PRNGKey(3)
    want, want_snaps = jax_ddim(jd, jnp.asarray(cond), jax_make_schedule(SCHED),
                                key, sampling_timesteps=steps, eta=eta,
                                continous=True)
    got, snaps = ddim_sample(td, torch.from_numpy(cond), make_schedule(SCHED),
                             injector(jax_draws(key, SHAPE, steps)),
                             sampling_timesteps=steps, eta=eta,
                             continous=True)
    # snapshots: the initial noise, then every step's image
    assert snaps.shape == np.asarray(want_snaps).shape == (steps + 1,) + SHAPE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(snaps.numpy(), np.asarray(want_snaps),
                               atol=ATOL, rtol=0)
    # the last step returns the clipped x0
    assert got.abs().max().item() <= 1.0


@pytest.mark.parametrize('sde', [False, True])
@pytest.mark.parametrize('steps', [4, 7])
def test_dpm_solver_pp_matches_jax(rng, sde, steps):
    cond = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    jd, td = toy_denoisers(cond)
    key = jax.random.PRNGKey(4)
    want, want_snaps = jax_dpm(jd, jnp.asarray(cond), jax_make_schedule(SCHED),
                               key, steps=steps, continous=True, sde=sde)
    draws = jax_draws(key, SHAPE, steps, per_step=sde)
    assert len(draws) == (steps + 1 if sde else 1)
    got, snaps = dpm_solver_pp_sample(
        td, torch.from_numpy(cond), make_schedule(SCHED), injector(draws),
        steps=steps, continous=True, sde=sde)
    # snapshots: every step's image, without the initial noise
    assert snaps.shape == np.asarray(want_snaps).shape == (steps,) + SHAPE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(snaps.numpy(), np.asarray(want_snaps),
                               atol=ATOL, rtol=0)


def test_dpm_sde_zeroes_the_draw_of_the_step_onto_t0(rng):
    """The last step lands on t = 0, where the injected draw is multiplied
    by 0: changing it changes nothing."""
    cond = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    _, td = toy_denoisers(cond)
    draws = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(5)]
    run = lambda d: dpm_solver_pp_sample(
        td, torch.from_numpy(cond), make_schedule(SCHED), injector(d),
        steps=4, sde=True)
    a = run(draws)
    b = run(draws[:-1] + [draws[-1] + 3.0])
    c = run(draws[:-2] + [draws[-2] + 3.0, draws[-1]])
    assert torch.equal(a, b) and not torch.equal(a, c)


TINY_UNET = dict(inner_channel=16, channel_mults=[1, 2], res_blocks=1,
                 attn_res=[], dropout=0.0)


def tiny_model_opt():
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(TINY_UNET)
    return model


@pytest.fixture(scope='module')
def tiny_pair():
    opt = {'model': tiny_model_opt()}
    torch.manual_seed(0)
    model = define_G(opt).eval()
    return model, jax_define_G(opt), convert_state_dict(model.state_dict())


@pytest.mark.parametrize('sampler,steps', [('ddim', 3), ('dpmpp', 4),
                                           ('dpmpp_sde', 4)])
def test_fewstep_slice_matches_jax_eval_step(rng, tiny_pair, sampler, steps):
    """The whole validation step of a `dropout: 0` model (folded head on both
    sides) under each few-step sampler: pad 64, predictor, hoisted guide
    maps, the loop, + initx, crop."""
    model, jm, params = tiny_pair
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=10)
    sr = rng.uniform(-1, 1, (1, 40, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    step = make_eval_step(jm, jax_make_schedule(sched_opt), pad=64,
                          continous=True, sampler=sampler,
                          sampling_timesteps=steps)
    want_sr, want_initx, want_snaps = step({'params': params}, sr, key)
    draws = jax_draws(key, (1, 168, 176, 3), steps,
                      per_step=sampler != 'dpmpp')
    got_sr, got_initx, got_snaps = eval_step(
        model, make_schedule(sched_opt), torch.from_numpy(sr), continous=True,
        noise=injector(draws), sampler=sampler, sampling_timesteps=steps)
    assert got_sr.shape == (1, 40, 48, 3)
    assert got_snaps.shape == np.asarray(want_snaps).shape
    np.testing.assert_allclose(got_initx.numpy(), np.asarray(want_initx),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_sr.numpy(), np.asarray(want_sr),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_snaps.numpy(), np.asarray(want_snaps),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize('sampler,given,want_calls', [
    ('ddpm', None, 6), ('ddim', None, 5), ('ddim', 3, 3), ('dpmpp', None, 20),
    ('dpmpp_sde', None, 5)])
def test_trainer_test_reads_sampler_and_steps(rng, sampler, given,
                                              want_calls):
    """Trainer.test takes opt['sampler'] and opt['sampling_timesteps'], with
    the JAX trainer's defaults: 20 steps for dpmpp, else 5; ddpm runs the
    schedule's own length."""
    opt = {'phase': 'val', 'model': tiny_model_opt(),
           'path': {'resume_state': None}, 'sampler': sampler,
           'sampling_timesteps': given,
           'train': {'ema_scheduler': {'use': True}}}
    opt['model']['unet'].update(inner_channel=8)
    opt['model']['beta_schedule']['val'] = dict(SID_VAL_SCHEDULE,
                                                n_timestep=6)
    trainer = Trainer(opt, device='cpu')
    calls = []
    inner = trainer.model.denoise_fn.forward
    trainer.model.denoise_fn.forward = \
        lambda *a, **k: calls.append(1) or inner(*a, **k)
    x = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    trainer.feed_data({'SR': x, 'HR': x})
    trainer.test(continous=False)
    assert len(calls) == want_calls
    assert trainer.SR.shape == (1, 16, 16, 3) and np.isfinite(trainer.SR).all()


def test_set_new_noise_schedule_force_rebuilds_the_phase():
    opt = {'phase': 'val', 'model': tiny_model_opt(),
           'path': {'resume_state': None},
           'train': {'ema_scheduler': {'use': True}}}
    opt['model']['unet'].update(inner_channel=8)
    trainer = Trainer(opt, device='cpu')
    before = trainer.schedules['val'].num_timesteps
    other = dict(opt['model']['beta_schedule']['val'], n_timestep=7)
    trainer.set_new_noise_schedule(other, 'val')
    assert trainer.schedules['val'].num_timesteps == before   # same phase
    trainer.set_new_noise_schedule(other, 'val', force=True)
    assert trainer.schedules['val'].num_timesteps == 7
