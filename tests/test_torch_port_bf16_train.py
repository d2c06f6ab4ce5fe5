"""The port's bfloat16 training path (`-p train --compute_dtype bf16`)
against the JAX package's, on the CPU.

Ops: the bf16 plain versions of the backward kernels K6 (`conv3x3_backward`)
and K5 (`akgm_block_tail_backward`), which the CPU runs in place of the
kernels, against the Pallas backward kernels B9 (`_conv3x3_backward`) and B8
(`_akgm_block_backward`) in interpret mode on the same numpy draws rounded
to bfloat16. Both compute in float32 on the same bf16 operands and round at
the same places (the staged x * a and + t; K6's dz; K5's z, A, z * A, do,
dz and the datt terms; every output once, the weight, bias and attention
gradients after their whole float32 sum); their float32 sums run in other
orders, and a sum next to a rounding boundary can flip a value by one ulp.
Tolerance, every output: within 2 bf16 ulps of the largest |value|, 2^-6 *
max|want|, and at least 99% of them the same bits (readings: every output
of K6 and of K5 with the fold or attw the same bits; K5 without either
99.70% to 99.93%, within 0.15 ulp of the largest). The folded cotangent of
a statistics-emitting op (`fold_stats_grad`) against the JAX package's
`_c3s_bwd` and `_st_bwd` folds: the same bits (both add in float32 in one
order and round once).

Slice: `train_step(compute_dtype=bf16)` against `make_train_step(...,
compute_dtype=jnp.bfloat16)` from the same weights on the same batch,
gammas and noise, dropout off, two AdamW steps. The JAX package's CPU path
differentiates its XLA composition, which rounds where that composition
rounds, not where the Pallas kernels do (the ops tests above hold those), so
the two bf16 runs agree to the size of a bf16 rounding schedule: each
step's loss within 2e-4 rel (readings 3.5e-5 and 1.0e-5; the port in
float32 reads 5.0e-3 and 6.8e-4 from the JAX bf16 run), the parameters
after as `check_params` holds float32 runs: every element within the most
that two sign-like AdamW steps the other way can give, the denoiser's within
0.1 lr on average (reading 0.055 lr; the float32 port reads 0.159 lr from
the JAX bf16 run). The masters, their gradients, the optimizer state and
the EMA shadow stay float32, and every kernel wrapper on the path, forward
and backward, sees bfloat16 operands and never float32.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.ops import conv_pallas
from ucdir_tpu.ops.akgm_pallas import _akgm_block_backward
from ucdir_tpu.ops.conv_pallas import _conv3x3_backward
from ucdir_tpu.ops.stats_pallas import _st_bwd
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train import (create_train_state as jax_create_state,
                             make_optimizer as jax_make_optimizer,
                             make_train_step)
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.ops.akgm import akgm_block_tail_backward
from ucdir_tpu_torch.ops.conv import conv3x3_backward
from ucdir_tpu_torch.ops.stats import fold_stats_grad
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.train import (create_train_state, make_optimizer,
                                   train_step)
from ucdir_tpu_torch.trainer import Trainer
from ucdir_tpu_torch.utils.convert_jax import from_jax_params

from test_torch_port_bf16 import BF, J, T, check_out, dispatched, draws, f32
from test_torch_port_train import (EMA_OPT, LR, SCHED_OPT, check_params,
                                   jax_draws, toy_batch, toy_opt,
                                   trainer_opt)

torch.set_num_threads(2)


def fold_draws(rng, B, C, fold):
    if not fold:
        return None, None
    return (*draws(rng, (B, C), scale=0.3, off=1.0),
            *draws(rng, (B, C), scale=0.2))


def check_grads(got, want, names):
    """Each output as `check_out`: 2 bf16 ulps of max|want|, 99% the same
    bits; an absent optional absent on both sides."""
    for g, w, n in zip(got, want, names):
        if w is None:
            assert g is None, n
            continue
        assert g is not None, n
        check_out(g.reshape(w.shape), w)


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv3x3_backward_bf16_matches_pallas(rng, fold, act):
    B, H, W, cin, cout = 2, 8, 16, 16, 24
    x, go = draws(rng, (B, H, W, cin), (B, H, W, cout))
    k, b = draws(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    a, t = fold_draws(rng, B, cin, fold)
    with pltpu.force_tpu_interpret_mode():
        want = _conv3x3_backward(J(x), J(k), J(b), J(go), act, J(a), J(t),
                                 rows_per_block=2)
    got = conv3x3_backward(T(x), T(k).reshape(9 * cin, cout), T(b), T(go),
                           act=act, norm_scale=T(a), norm_shift=T(t))
    check_grads(got, want, ['dx', 'dw', 'dbias', 'dnorm_scale',
                            'dnorm_shift'])


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('attw_on', [False, True])
def test_akgm_tail_backward_bf16_matches_pallas(rng, fold, attw_on):
    # C / G = 2: a candidate-pairing fault changes every gradient
    B, H, W, C, G = 2, 8, 16, 16, 8
    h, att, res, go = draws(rng, (B, H, W, C), (B, H, W, G), (B, H, W, C),
                            (B, H, W, C))
    k, b = draws(rng, (3, 3, C // G, C * G), (C * G,), scale=0.1)
    a, t = fold_draws(rng, B, C, fold)
    aw = draws(rng, (B, G), off=1.0)[0] if attw_on else None
    with pltpu.force_tpu_interpret_mode():
        want = _akgm_block_backward(J(h), J(att), J(k), J(b), J(res), J(go),
                                    G, J(a), J(t), J(aw), rows_per_block=2)
    got = akgm_block_tail_backward(
        T(h), T(att), T(k).reshape(9 * C // G, C * G), T(b), T(go), G,
        norm_scale=T(a), norm_shift=T(t), attw=T(aw))
    check_grads(got, want, ['dh', 'datt', 'dw', 'dbias', 'dres',
                            'dnorm_scale', 'dnorm_shift', 'dattw'])


@pytest.mark.parametrize('kind', ['conv_stats', 'conv_stats_no_g',
                                  'gn1_stats'])
def test_fold_stats_grad_bf16_matches_jax(rng, kind, monkeypatch):
    """The cotangent of a bf16 output with its statistics' float32
    cotangents folded in: g + ds + 2 * out * dq in float32, rounded once, as
    `_c3s_bwd` (whose conv backward is replaced here by one that returns the
    folded cotangent it is given) and `_st_bwd` compute it: the same bits.
    Rounding g + ds first, as bf16 arithmetic would, changes some."""
    B, H, W, C = 2, 8, 16, 24
    out, go = draws(rng, (B, H, W, C), (B, H, W, C))
    ds, dq = (rng.standard_normal((B, C)).astype(np.float32) * s
              for s in (0.3, 0.2))
    if kind == 'gn1_stats':
        (want,) = _st_bwd(J(out), (jnp.asarray(ds), jnp.asarray(dq)))
        got = fold_stats_grad(None, T(out), torch.from_numpy(ds),
                              torch.from_numpy(dq))
    else:
        monkeypatch.setattr(conv_pallas, '_c3_bwd',
                            lambda act, residuals, g: g)
        g = go if kind == 'conv_stats' else np.zeros_like(go)
        want = conv_pallas._c3s_bwd(
            None, (None,) * 5 + (J(out),),
            (J(g), jnp.asarray(ds), jnp.asarray(dq)))
        got = fold_stats_grad(T(go) if kind == 'conv_stats' else None,
                              T(out), torch.from_numpy(ds),
                              torch.from_numpy(dq))
    assert got.dtype == BF and got.shape == (B, H, W, C)
    np.testing.assert_array_equal(f32(got), f32(want))
    if kind == 'conv_stats':
        twice = (T(go) + torch.from_numpy(ds)[:, None, None, :].to(BF)
                 + (2. * T(out).float() * torch.from_numpy(dq)[
                     :, None, None, :]).to(BF))
        assert (f32(twice) != f32(want)).any()


def test_bf16_train_steps_match_jax(rng, monkeypatch):
    """Two AdamW steps in bf16 on float32 masters against the JAX package's
    (tolerances: the module docstring)."""
    opt = toy_opt()
    torch.manual_seed(2)
    model = define_G(opt).train()
    params = convert_state_dict(model.state_dict())
    batch = toy_batch(rng)
    jsched = jax_make_schedule(SCHED_OPT)
    jstate = jax_create_state(params, jax_make_optimizer(
        {'type': 'adamw', 'lr': LR}), EMA_OPT)
    jstep = make_train_step(jax_define_G(opt), jsched, donate=False,
                            compute_dtype=jnp.bfloat16)
    state = create_train_state(model, make_optimizer(
        model.parameters(), {'type': 'adamw', 'lr': LR}), EMA_OPT)
    sched = make_schedule(SCHED_OPT)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    seen = dispatched(monkeypatch)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 2)):
        gammas, noise = jax_draws(key, jsched, batch['HR'].shape)
        jstate, m = jstep(jstate, jbatch, key)
        loss = train_step(state, sched, tbatch, draws={
            'gammas': torch.from_numpy(gammas),
            'noise': torch.from_numpy(noise)}, compute_dtype=BF)
        assert loss.dtype == torch.float32
        np.testing.assert_allclose(loss.item(), float(m['l_pix']),
                                   rtol=2e-4, err_msg='step %d' % i)
        if i == 0:
            # every kernel wrapper, forward and backward, took bf16 only
            assert {'_conv3x3_forward', '_akgm_block_tail_forward',
                    '_conv1x1_forward', '_gn1_stats_forward',
                    'conv3x3_backward', 'akgm_block_tail_backward'} <= set(
                        seen), seen
            assert all(d == {BF} for d in seen.values()), seen
            monkeypatch.undo()
            for p in model.parameters():
                assert p.dtype == p.grad.dtype == torch.float32
    assert state.step == int(jstate.step) == 2
    for group in state.optimizer.state.values():
        for v in group.values():
            assert not torch.is_tensor(v) or v.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in state.ema_params.values())
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = {k: v.numpy() for k, v in from_jax_params(jstate.params).items()}
    assert got.keys() == want.keys()
    check_params(got, want, 2)


def test_bf16_trainer_saves_float32_and_resumes_bit_for_bit(rng, tmp_path):
    """Trainer in its train phase with compute_dtype bf16 (dropout on):
    optimize_parameters runs, save_network writes float32 weights, shadow and
    optimizer state, and a resumed trainer repeats the next step's loss and
    weights bit for bit."""
    opt = dict(trainer_opt(tmp_path), compute_dtype='bf16')
    trainer = Trainer(opt, device='cpu', seed=4)
    batch = toy_batch(rng)
    trainer.feed_data(batch)
    for _ in range(3):
        trainer.optimize_parameters()
    assert np.isfinite(trainer.get_current_log()['l_pix'])
    assert trainer.iter == trainer.state.step == 3
    prefix = trainer.save_network(1, 3)
    for suffix in ('_gen.pth', '_gen_ema.pth', '_opt.pth'):
        saved = torch.load(prefix + suffix, weights_only=True)
        tensors = [v for v in jax.tree_util.tree_leaves(saved)
                   if torch.is_tensor(v) and v.is_floating_point()]
        assert tensors and all(v.dtype == torch.float32 for v in tensors), \
            suffix
    resumed = Trainer(dict(trainer_opt(tmp_path, resume=prefix),
                           compute_dtype='bf16'), device='cpu', seed=4)
    for t in (trainer, resumed):
        t.feed_data(batch)
        t.optimize_parameters()
    assert resumed.log_dict['l_pix'] == trainer.log_dict['l_pix']
    for k, v in trainer.model.state_dict().items():
        assert v.dtype == torch.float32, k
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert os.path.isfile(prefix + '_opt.pth')
