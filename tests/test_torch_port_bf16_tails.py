"""The port's bfloat16 AKGM tails 'mix' (K8) and 'packed' (K9) against the
JAX package's, on the CPU.

Ops: the bf16 plain versions of K8 (`akgm_mix_reference`) and K9
(`akgm_block_tail_packed_plain`), which the CPU runs in place of the
kernels, against the Pallas kernels B10 (`_akgm_forward`) and B1p
(`_akgm_block_forward_packed`) in interpret mode on the same numpy draws
rounded to bfloat16. Both compute in float32 on the same bf16 operands and
round at the same places (K8: the output once; K9: att * attw, the group's
attention times a, each staged h * mult, the ring -t / a, the bias matrix,
the output); their float32 sums run in other orders, and a sum next to a
rounding boundary can flip an output by one ulp. Tolerance as
tests/test_torch_port_bf16.py: outputs within 2 bf16 ulps of the largest
|value| and at least 99% of them the same bits.

K8's gradients: the autograd of its bf16 plain version (float32 on the bf16
values, each gradient rounded once) against `jax.vjp` of `akgm_mix_pallas`
in bf16, whose backward is the XLA reference in bf16 (the conv's output and
the einsum rounded to bf16 there): dh, datt and dw within 2e-2 of their
largest |value| (readings 3.5e-3 to 5.2e-3), dbias within 4e-2 (reading
2.8e-2: its sum over the pixels runs in bf16 there, 2.9e-2 of the largest
from float64, the port's 1.3e-3).

Slice: the tiny model under tail 'mix' in bf16 against the JAX model with
UCDIR_TPU_NO_FUSED_TAIL=1 (on the CPU its path is the XLA composition
either way), 3 DDPM steps: within the bf16 slice test's 2.5e-3 mean abs and
3e-2 max abs. The JAX package computes the packed network only on a TPU,
so the 'packed' model is held to the op test above and to its own float32
within the JAX test's 0.05 mean abs (tests/test_diffusion.py).

Train: two AdamW steps in bf16 against two in float32 under each tail, the
same weights, batch and draws: each loss within 1e-2 rel (bf16 against
float32 at this size reads 4.7e-3 to 5.1e-3 at the first step and 7e-4 to
9.5e-4 at the second, the 'fused' tail's alike), every parameter within
2 * lr a step, the masters float32, and every kernel wrapper on the path
fed bf16 only. Under 'mix' also against the JAX package's
`make_train_step(compute_dtype=jnp.bfloat16)` with UCDIR_TPU_NO_FUSED_TAIL=1,
as tests/test_torch_port_bf16_train.py holds the 'fused' tail: each loss
within 2e-4 rel, the parameters as `check_params`.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucdir_tpu.diffusion.sampler import super_resolution as jax_sr
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.ops.akgm_pallas import (_akgm_block_forward_packed,
                                       _akgm_forward, _pack_grouped_kernel,
                                       akgm_mix_pallas)
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train import (create_train_state as jax_create_state,
                             make_optimizer as jax_make_optimizer,
                             make_train_step)
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
from ucdir_tpu_torch.diffusion.sampler import super_resolution
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.ops.akgm import (akgm_block_tail_packed, akgm_mix,
                                      pack_grouped_weight)
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.train import (create_train_state, make_optimizer,
                                   train_step)
from ucdir_tpu_torch.utils.convert_jax import from_jax_params

from test_torch_port_bf16 import (BF, J, T, check_out, dispatched, draws,
                                  f32, tiny_model_opt)
from test_torch_port_slice import jax_draws
from test_torch_port_train import (EMA_OPT, LR, SCHED_OPT, check_params,
                                   toy_batch, toy_opt)
from test_torch_port_train import jax_draws as jax_train_draws

torch.set_num_threads(2)

G = 8


def mix_draws(rng, B, H, W, C):
    h, att = draws(rng, (B, H, W, C), (B, H, W, G))
    k, b = draws(rng, (3, 3, C // G, C * G), (C * G,), scale=0.3)
    return h, att, k, b


# C / G = 2, so a candidate-pairing fault shows; then a ragged size whose
# groups are 3 channels wide
@pytest.mark.parametrize('B,H,W,C', [(2, 8, 16, 16), (1, 9, 13, 24)])
def test_akgm_mix_bf16_matches_pallas(rng, B, H, W, C):
    h, att, k, b = mix_draws(rng, B, H, W, C)
    with pltpu.force_tpu_interpret_mode():
        want = _akgm_forward(J(h), J(att), J(k), J(b), G)
    got = akgm_mix(T(h), T(att), T(k).reshape(9 * C // G, C * G), T(b), G)
    check_out(got, want)


@pytest.mark.parametrize('B,H,W,C', [(2, 8, 16, 16), (1, 9, 13, 24)])
@pytest.mark.parametrize('fold', [False, True])
def test_akgm_packed_bf16_matches_pallas(rng, fold, B, H, W, C):
    h, att, k, b = mix_draws(rng, B, H, W, C)
    (res,) = draws(rng, (B, H, W, C))
    (aw,) = draws(rng, (B, G), off=1.0)
    a = t = None
    if fold:
        a, t = (*draws(rng, (B, C), scale=0.3, off=1.0),
                *draws(rng, (B, C), scale=0.2))
    with pltpu.force_tpu_interpret_mode():
        want = _akgm_block_forward_packed(J(h), J(att), J(k), J(b), J(res),
                                          G, J(a), J(t), J(aw))
    wp = pack_grouped_weight(T(k).reshape(9 * C // G, C * G), G)
    np.testing.assert_array_equal(
        f32(wp), f32(_pack_grouped_kernel(J(k), C, G)))
    got = akgm_block_tail_packed(T(h), T(att), wp, T(b), T(res), G,
                                 norm_scale=T(a), norm_shift=T(t),
                                 attw=T(aw))
    check_out(got, want)


def test_akgm_mix_bf16_gradients_match_jax(rng):
    B, H, W, C = 2, 8, 16, 16
    h, att, k, b = mix_draws(rng, B, H, W, C)
    (g,) = draws(rng, (B, H, W, C))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *xs: akgm_mix_pallas(*xs, G),
                         J(h), J(att), J(k), J(b))
        want = vjp(J(g))
    leaves = [T(v).requires_grad_(True) for v in (h, att)] + [
        T(k).reshape(9 * C // G, C * G).requires_grad_(True),
        T(b).requires_grad_(True)]
    out = akgm_mix(*leaves, G)
    got = torch.autograd.grad(out, leaves, T(g))
    for name, gv, wv in zip(('dh', 'datt', 'dw', 'dbias'), got, want):
        assert gv.dtype == BF, name
        gv, wv = f32(gv).reshape(wv.shape), f32(wv)
        err = np.abs(gv - wv).max() / np.abs(wv).max()
        assert err <= (4e-2 if name == 'dbias' else 2e-2), (name, err)


def test_bf16_mix_slice_matches_jax(rng, monkeypatch):
    monkeypatch.setenv('UCDIR_TPU_NO_FUSED_TAIL', '1')
    opt = {'model': tiny_model_opt()}
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=3)
    torch.manual_seed(0)
    model = define_G(opt).eval()
    assert {layer.res_block.tail for _, layer, _ in
            model.denoise_fn.guide_block_scales()} == {'mix'}
    params = convert_state_dict(model.state_dict())
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want, _ = jax.jit(lambda v, xx, kk: jax_sr(
        jax_define_G(opt), v, jax_make_schedule(sched_opt), xx, kk,
        compute_dtype=jnp.bfloat16))({'params': params}, x, key)
    d = iter(jax_draws(key, x.shape, 3))
    seen = dispatched(monkeypatch)
    sr, _ = super_resolution(
        model, make_schedule(sched_opt), torch.from_numpy(x),
        noise=lambda shape: torch.from_numpy(next(d)), compute_dtype=BF)
    assert 'forward' in seen and all(v == {BF} for v in seen.values()), seen
    assert sr.dtype == torch.float32
    err = np.abs(sr.numpy() - np.asarray(want))
    assert err.mean() <= 2.5e-3 and err.max() <= 3e-2, (err.mean(),
                                                        err.max())


def test_bf16_packed_slice_stays_near_fp32(rng):
    torch.manual_seed(0)
    model = define_G({'model': tiny_model_opt(tail='packed')}).eval()
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3))
                         .astype(np.float32))
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=3))
    outs = [super_resolution(model, sched, x,
                             generator=torch.Generator().manual_seed(3),
                             compute_dtype=dt)[0] for dt in (BF, None)]
    assert outs[0].dtype == torch.float32
    assert torch.isfinite(outs[0]).all()
    assert (outs[0] - outs[1]).abs().mean().item() < 0.05


@pytest.mark.parametrize('tail', ['mix', 'packed'])
def test_bf16_train_steps_near_fp32(rng, tail, monkeypatch):
    opt = toy_opt()
    opt['model']['unet']['tail'] = tail
    torch.manual_seed(2)
    models = [define_G(opt).train()]
    models.append(copy.deepcopy(models[0]))
    states = [create_train_state(m, make_optimizer(
        m.parameters(), {'type': 'adamw', 'lr': LR}), EMA_OPT)
        for m in models]
    sched = make_schedule(SCHED_OPT)
    jsched = jax_make_schedule(SCHED_OPT)
    batch = {k: torch.from_numpy(v) for k, v in toy_batch(rng).items()}
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 2)):
        gammas, noise = jax_train_draws(key, jsched, batch['HR'].shape)
        dr = {'gammas': torch.from_numpy(gammas),
              'noise': torch.from_numpy(noise)}
        seen = dispatched(monkeypatch)
        low = train_step(states[0], sched, batch, draws=dr, compute_dtype=BF)
        monkeypatch.undo()
        if i == 0:
            assert {'forward', '_conv3x3_forward', 'conv3x3_backward'} <= \
                set(seen), seen
            assert all(v == {BF} for v in seen.values()), seen
        ref = train_step(states[1], sched, batch, draws=dr)
        assert low.dtype == torch.float32
        np.testing.assert_allclose(low.item(), ref.item(), rtol=1e-2,
                                   err_msg='step %d' % i)
    for (name, p), q in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert (p - q).abs().max().item() <= 2 * LR * 2 * 1.1, name


def test_bf16_mix_train_steps_match_jax(rng, monkeypatch):
    monkeypatch.setenv('UCDIR_TPU_NO_FUSED_TAIL', '1')
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
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 2)):
        gammas, noise = jax_train_draws(key, jsched, batch['HR'].shape)
        jstate, m = jstep(jstate, jbatch, key)
        loss = train_step(state, sched, tbatch, draws={
            'gammas': torch.from_numpy(gammas),
            'noise': torch.from_numpy(noise)}, compute_dtype=BF)
        np.testing.assert_allclose(loss.item(), float(m['l_pix']),
                                   rtol=2e-4, err_msg='step %d' % i)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = {k: v.numpy() for k, v in from_jax_params(jstate.params).items()}
    assert got.keys() == want.keys()
    check_params(got, want, 2)
