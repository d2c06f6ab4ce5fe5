"""Gradients of the port (ucdir_tpu_torch, on the CPU through the plain
versions of the backward kernels K5 and K6) against the JAX package: the
fused Pallas backward kernels in interpret mode, `jax.vjp` through the
statistics-emitting functions, and `jax.value_and_grad` of the whole loss on
the same weights, batch, gamma and noise.

Tolerance: the JAX package's own for its backward kernels, 2e-3 rel / 1e-4
abs (tests/test_conv_pallas.py, tests/test_akgm_pallas.py: the kernels sum
row blocks in another order than the composition); for whole-model gradients
2e-3 of the largest gradient of each parameter plus 1e-6 abs, float32 on both
sides through ~30 layers. Readings: at most 1e-5 of the largest gradient for
every parameter but the predictor's conv3_1 and conv3_2, whose gradients are
sums that nearly cancel (1e-4 of the other layers') and read up to 4e-4.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.ops.akgm_pallas import (_akgm_block_backward,
                                       akgm_block_stats_pallas)
from ucdir_tpu.ops.conv_pallas import (_conv3x3_backward, conv1x1_pallas,
                                       conv3x3_stats_pallas)
from ucdir_tpu.ops.stats_pallas import gn1_stats_pallas
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_MODEL
from ucdir_tpu_torch.models.akgm import ResnetBlockDY3h
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.models.layers import Conv1, Conv3, Downsample, Upsample
from ucdir_tpu_torch.ops.akgm import akgm_block_tail, akgm_block_tail_backward
from ucdir_tpu_torch.ops.conv import conv1x1, conv3x3, conv3x3_backward
from ucdir_tpu_torch.ops.stats import gn1_stats
from ucdir_tpu_torch.utils.convert_jax import from_jax_grads

torch.set_num_threads(2)

RTOL, ATOL = 2e-3, 1e-4


def close(got, want, name='', rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


def arrays(rng, *shapes, scale=0.5, off=0.0):
    return [(rng.standard_normal(s) * scale + off).astype(np.float32)
            for s in shapes]


def T(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def J(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv3x3_backward_plain_matches_pallas_backward(rng, fold, act):
    B, H, W, cin, cout = 2, 8, 16, 16, 24
    x, go = arrays(rng, (B, H, W, cin), (B, H, W, cout))
    k, b = arrays(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    a = t = None
    if fold:
        (a,), (t,) = arrays(rng, (B, cin), scale=0.3, off=1.0), \
            arrays(rng, (B, cin), scale=0.2)
    with pltpu.force_tpu_interpret_mode():
        want = _conv3x3_backward(J(x), J(k), J(b), J(go), act, J(a), J(t),
                                 rows_per_block=2)
    got = conv3x3_backward(T(x), T(k).reshape(9 * cin, cout), T(b), T(go),
                           act=act, norm_scale=T(a), norm_shift=T(t))
    names = ['dx', 'dw', 'dbias', 'dnorm_scale', 'dnorm_shift']
    for g, w, n in zip(got, want, names):
        if w is None:
            assert g is None, n
            continue
        close(g.reshape(w.shape), w, n)


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('attw_on', [False, True])
def test_akgm_tail_backward_plain_matches_pallas_backward(rng, fold,
                                                          attw_on):
    # C / G = 2: a candidate-pairing fault changes every gradient
    B, H, W, C, G = 2, 8, 16, 16, 8
    h, att, res, go = arrays(rng, (B, H, W, C), (B, H, W, G), (B, H, W, C),
                             (B, H, W, C))
    k, b = arrays(rng, (3, 3, C // G, C * G), (C * G,), scale=0.1)
    a = t = aw = None
    if fold:
        (a,), (t,) = arrays(rng, (B, C), scale=0.3, off=1.0), \
            arrays(rng, (B, C), scale=0.2)
    if attw_on:
        (aw,) = arrays(rng, (B, G), scale=0.5, off=1.0)
    with pltpu.force_tpu_interpret_mode():
        want = _akgm_block_backward(J(h), J(att), J(k), J(b), J(res), J(go),
                                    G, J(a), J(t), J(aw), rows_per_block=2)
    got = akgm_block_tail_backward(
        T(h), T(att), T(k).reshape(9 * C // G, C * G), T(b), T(go), G,
        norm_scale=T(a), norm_shift=T(t), attw=T(aw))
    names = ['dh', 'datt', 'dw', 'dbias', 'dres', 'dnorm_scale',
             'dnorm_shift', 'dattw']
    for g, w, n in zip(got, want, names):
        if w is None:
            assert g is None, n
            continue
        close(g.reshape(w.shape), w, n)


def _weighted(outs, weights):
    return sum((o * w).sum() for o, w in zip(outs, weights))


@pytest.mark.parametrize('op', ['conv3x3', 'conv3x3_fold', 'akgm_tail',
                                'gn1_stats', 'conv1x1'])
def test_function_gradients_match_jax_vjp(rng, op):
    """Gradients through every output of each autograd Function, the
    statistics included (their cotangents fold into the output's as
    ds + 2 * out * dq), against jax.grad of the JAX package's custom-vjp
    functions in interpret mode."""
    B, H, W, C, G = 2, 8, 16, 16, 8
    x, res = arrays(rng, (B, H, W, C), (B, H, W, C))
    (att,) = arrays(rng, (B, H, W, G))
    k3, b3 = arrays(rng, (3, 3, C, C), (C,), scale=0.1)
    kg, bg = arrays(rng, (3, 3, C // G, C * G), (C * G,), scale=0.1)
    k1, = arrays(rng, (1, 1, C, C), scale=0.2)
    (a,), (t,) = arrays(rng, (B, C), scale=0.3, off=1.0), \
        arrays(rng, (B, C), scale=0.2)
    (aw,) = arrays(rng, (B, G), scale=0.5, off=1.0)
    w_o, = arrays(rng, (B, H, W, C), scale=1.0)
    w_s, w_q = arrays(rng, (B, C), (B, C), scale=0.3)
    wts = (w_o, w_s, w_q)

    if op in ('conv3x3', 'conv3x3_fold'):
        ins = [x, k3, b3] + ([a, t] if op == 'conv3x3_fold' else [])

        def jf(x, k, b, a=None, t=None):
            return conv3x3_stats_pallas(x, k, b, 'swish', a, t)

        def pf(x, k, b, a=None, t=None):
            out, (s, q) = conv3x3(x, k.reshape(9 * C, C), b, act='swish',
                                  norm_scale=a, norm_shift=t, emit_stats=True)
            return out, s, q
    elif op == 'akgm_tail':
        ins = [x, att, kg, bg, res, a, t, aw]

        def jf(h, att, k, b, res, a, t, aw):
            return akgm_block_stats_pallas(h, att, k, b, res, G, a, t, aw)

        def pf(h, att, k, b, res, a, t, aw):
            out, (s, q) = akgm_block_tail(
                h, att, k.reshape(9 * C // G, C * G), b, res, G,
                norm_scale=a, norm_shift=t, attw=aw, emit_stats=True)
            return out, s, q
    elif op == 'gn1_stats':
        ins, wts = [x], (w_s, w_q)
        jf, pf = gn1_stats_pallas, gn1_stats
    else:
        ins, wts = [x, k1, b3], (w_o,)

        def jf(x, k, b):
            return (conv1x1_pallas(x, k, b, 'swish'),)

        def pf(x, k, b):
            return (conv1x1(x, k.reshape(C, C), b, act='swish'),)

    def jloss(*xs):
        with pltpu.force_tpu_interpret_mode():
            return _weighted(jf(*xs), [J(w) for w in wts])

    want = jax.grad(jloss, argnums=tuple(range(len(ins))))(*map(J, ins))
    leaves = [T(v, grad=True) for v in ins]
    _weighted(pf(*leaves), [T(w) for w in wts]).backward()
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        close(leaf.grad, w, '%s input %d' % (op, i))


@pytest.mark.parametrize('kind', ['conv3', 'conv1', 'upsample', 'downsample',
                                  'akgm_block'])
def test_conv_modules_give_their_weights_a_gradient(rng, kind):
    """The kernel-layout repack is differentiable: loss.backward() fills the
    OIHW parameters' .grad (it was None while the repack ran under
    no_grad), and the output of Upsample requires grad."""
    x = T(arrays(rng, (2, 8, 8, 16))[0])
    if kind == 'akgm_block':
        m = ResnetBlockDY3h(16, 16, 8)
        out, _ = m(x, T(arrays(rng, (2, 8))[0]), T(arrays(rng, (2, 8, 8, 3))[0]))
    else:
        m = {'conv3': lambda: Conv3(16, 8), 'conv1': lambda: Conv1(16, 8),
             'upsample': lambda: Upsample(16),
             'downsample': lambda: Downsample(16)}[kind]()
        out = m(x)
    assert out.requires_grad
    (out * out).sum().backward()
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
    # validation keeps its cache: no grad, the same tensor twice
    if kind == 'conv3':
        with torch.no_grad():
            assert m.kernel_weight() is m.kernel_weight()


# the SID model at toy size: 2 levels, attention in mid_0 only (at /2)
TOY_UNET = dict(inner_channel=16, channel_mults=[1, 2], res_blocks=1,
                attn_res=[])


def toy_opt():
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(TOY_UNET)
    return {'model': model}


def toy_batch(rng, B=2, size=40):
    hr, sr, noise = arrays(rng, (B, size, size, 3), (B, size, size, 3),
                           (B, size, size, 3))
    gammas = rng.uniform(0.3, 0.95, (B, 1)).astype(np.float32)
    return {'HR': hr * 0.6, 'SR': sr * 0.3}, gammas, noise


def test_every_parameter_receives_a_gradient(rng):
    """After loss.backward() in train() mode (dropout on) every parameter of
    DY3h and of the predictor has a finite, non-zero .grad."""
    torch.manual_seed(0)
    model = define_G(toy_opt()).train()
    batch, gammas, noise = toy_batch(rng)
    gen = torch.Generator().manual_seed(3)
    loss = model.p_losses({k: T(v) for k, v in batch.items()}, T(gammas),
                          T(noise), dropout_generator=gen)
    loss.backward()
    assert torch.isfinite(loss)
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith('predictor.') for n in names)
    assert any(n.startswith('denoise_fn.') for n in names)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


def test_p_losses_and_gradients_match_jax(rng):
    """Loss and every parameter's gradient against jax.value_and_grad of the
    JAX module: same weights, batch, gammas and noise, dropout off (the two
    frameworks draw different masks)."""
    opt = toy_opt()
    torch.manual_seed(1)
    model = define_G(opt).eval()
    params = convert_state_dict(model.state_dict())
    jm = jax_define_G(opt)
    batch, gammas, noise = toy_batch(rng)

    def jloss(p):
        return jm.apply({'params': p}, {k: J(v) for k, v in batch.items()},
                        J(gammas), J(noise), deterministic=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = from_jax_grads(want_grads)
    loss = model.p_losses({k: T(v) for k, v in batch.items()}, T(gammas),
                          T(noise))
    loss.backward()
    # a sum of 2 * 40 * 40 * 3 absolute differences, about 1e4
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, w in want.items():
        close(got[name], w, name, rtol=0,
              atol=2e-3 * np.abs(w).max() + 1e-6)
