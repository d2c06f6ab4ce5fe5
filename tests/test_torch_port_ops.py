"""The port's ops (ucdir_tpu_torch.ops, on the CPU through the kernels' plain
versions) against the JAX package's functions, the Pallas ones in interpret
mode, on the same numpy inputs.

Tolerance: 1e-5 abs / 1e-4 rel in float32 — the two sides sum the same
products in different orders (XLA's and oneDNN's convolutions, Pallas's
im2col dots); statistics, sums over a whole image, get 1e-4 rel.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucdir_tpu.ops.akgm_pallas import _akgm_block_forward, _block_ref
from ucdir_tpu.ops.conv_pallas import (_conv1x1_forward, _conv3x3_forward,
                                       _downconv_forward, upconv2x)
from ucdir_tpu.ops.stats_pallas import gn1_stats_pallas
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu_torch.ops import _build
from ucdir_tpu_torch.ops.akgm import akgm_block_tail
from ucdir_tpu_torch.ops.conv import (conv1x1, conv3x3, pack_up_kernel,
                                      upconv2x as port_upconv2x)
from ucdir_tpu_torch.ops.stats import gn1_stats
from ucdir_tpu_torch.schedule import make_schedule

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def arrays(rng, *shapes, scale=0.5):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def fold_args(rng, B, C, fold):
    if not fold:
        return None, None
    a = (rng.standard_normal((B, C)) * 0.3 + 1.0).astype(np.float32)
    t = (rng.standard_normal((B, C)) * 0.2).astype(np.float32)
    return a, t


def T(a):
    return None if a is None else torch.from_numpy(a)


def J(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize('fold', [False, True])
def test_akgm_block_tail_matches_pallas_and_reference(rng, fold):
    # C / G = 2, so a candidate-pairing fault changes the output
    B, H, W, C, G = 2, 8, 16, 16, 8
    h, att, res = arrays(rng, (B, H, W, C), (B, H, W, G), (B, H, W, C))
    k, b = arrays(rng, (3, 3, C // G, C * G), (C * G,), scale=0.2)
    aw = (rng.standard_normal((B, G)) * 0.5 + 1.0).astype(np.float32)
    a, t = fold_args(rng, B, C, fold)
    jargs = (J(h), J(att), J(k), J(b), J(res), G, J(a), J(t), J(aw))
    with pltpu.force_tpu_interpret_mode():
        want, ws, wq = _akgm_block_forward(*jargs, emit_stats=True)
    ref = _block_ref(*jargs)
    got, (s, q) = akgm_block_tail(
        T(h), T(att), T(k).reshape(9 * C // G, C * G), T(b), T(res), G,
        norm_scale=T(a), norm_shift=T(t), attw=T(aw), emit_stats=True)
    close(got, want)
    close(got, ref)
    close(s, ws[:, 0] if ws.ndim == 3 else ws, atol=1e-4)
    close(q, wq[:, 0] if wq.ndim == 3 else wq, atol=1e-4)


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv3x3_matches_pallas(rng, fold, act):
    B, H, W, cin, cout = 2, 8, 16, 16, 24
    (x,) = arrays(rng, (B, H, W, cin))
    k, b = arrays(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    a, t = fold_args(rng, B, cin, fold)
    with pltpu.force_tpu_interpret_mode():
        want, ws, wq = _conv3x3_forward(J(x), J(k), J(b), act, J(a), J(t),
                                        emit_stats=True)
    got, (s, q) = conv3x3(T(x), T(k).reshape(9 * cin, cout), T(b), act=act,
                          norm_scale=T(a), norm_shift=T(t), emit_stats=True)
    close(got, want)
    close(s, ws, atol=1e-4)
    close(q, wq, atol=1e-4)


@pytest.mark.parametrize('fold', [False, True])
def test_conv3x3_stride2_matches_pallas_downconv(rng, fold):
    B, H, W, cin, cout = 1, 16, 16, 8, 16
    (x,) = arrays(rng, (B, H, W, cin))
    k, b = arrays(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    a, t = fold_args(rng, B, cin, fold)
    with pltpu.force_tpu_interpret_mode():
        want, ws, wq = _downconv_forward(J(x), J(k), J(b), J(a), J(t),
                                         emit_stats=True)
    got, (s, q) = conv3x3(T(x), T(k).reshape(9 * cin, cout), T(b), stride=2,
                          norm_scale=T(a), norm_shift=T(t), emit_stats=True)
    assert got.shape == (B, H // 2, W // 2, cout)
    close(got, want)
    close(s, ws, atol=1e-4)
    close(q, wq, atol=1e-4)


def test_upconv2x_matches_jax(rng, monkeypatch):
    # 'xla' makes the JAX op emit its statistics on the CPU too
    monkeypatch.setenv('UCDIR_TPU_CHAIN_STATS', 'xla')
    B, H, W, cin, cout = 1, 6, 10, 8, 12
    (x,) = arrays(rng, (B, H, W, cin))
    k, b = arrays(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    want, (wt, wqt) = upconv2x(J(x), J(k), J(b), emit_stats=True)
    wp = pack_up_kernel(T(k)).reshape(9 * cin, 4 * cout)
    got, (s, q) = port_upconv2x(T(x), wp, T(b).repeat(4), emit_stats=True)
    assert got.shape == (B, 2 * H, 2 * W, cout)
    close(got, want)
    close(s.sum(1), wt, atol=1e-4)
    close(q.sum(1), wqt, atol=1e-4)
    # and it is nearest-x2 followed by the 3x3 convolution, exactly
    up = T(x).repeat_interleave(2, 1).repeat_interleave(2, 2)
    close(got, conv3x3(up, T(k).reshape(9 * cin, cout), T(b)))


@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv1x1_matches_pallas(rng, act):
    B, H, W, cin, cout = 2, 8, 16, 24, 16
    (x,) = arrays(rng, (B, H, W, cin))
    k, b = arrays(rng, (1, 1, cin, cout), (cout,), scale=0.2)
    with pltpu.force_tpu_interpret_mode():
        want = _conv1x1_forward(J(x), J(k), J(b), act)
    got = conv1x1(T(x), T(k).reshape(cin, cout), T(b), act=act)
    close(got, want)


@pytest.mark.parametrize('shape', [(1, 8, 16, 16), (2, 12, 16, 40)])
def test_gn1_stats_matches_pallas(rng, shape):
    (x,) = arrays(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        ws, wq = gn1_stats_pallas(J(x))
    s, q = gn1_stats(T(x))
    close(s, ws, atol=1e-4)
    close(q, wq, atol=1e-4)


@pytest.mark.parametrize('name', ['linear', 'quad', 'cosine', 'warmup10'])
def test_schedule_matches_jax(name):
    opt = {'schedule': name, 'n_timestep': 50, 'linear_start': 1e-6,
           'linear_end': 0.4 if name != 'cosine' else 0.02}
    want, got = jax_make_schedule(opt), make_schedule(opt)
    assert got.num_timesteps == want.num_timesteps == 50
    for f in ('betas', 'alphas_cumprod', 'sqrt_recip_alphas_cumprod',
              'sqrt_recipm1_alphas_cumprod', 'posterior_log_variance_clipped',
              'posterior_mean_coef1', 'posterior_mean_coef2',
              'sqrt_alphas_cumprod_prev'):
        # both round the same float64 values to float32
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 4, 4, 8, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        gn1_stats(x)
    with pytest.raises(ValueError, match='unsupported device'):
        conv1x1(x, torch.empty(8, 8, device='meta'),
                torch.empty(8, device='meta'))


def test_check_refuses_host_and_half_tensors():
    # the kernels' argument check: CUDA, the entry's dtype, shape,
    # contiguity; float16 has no entry point, bfloat16 only K1..K4 and K7's
    with pytest.raises(ValueError, match='CUDA'):
        _build.check('x', torch.zeros(2, 3))
    with pytest.raises(TypeError, match='float32'):
        _build.entry('conv3x3', torch.zeros(2, 3, dtype=torch.float16))
    with pytest.raises(TypeError, match='ROADMAP'):
        _build.entry('akgm_mix', torch.zeros(2, 3, dtype=torch.bfloat16))
    assert _build.entry('conv3x3', torch.zeros(1)) == 'conv3x3'
    assert _build.entry('akgm_tail', torch.zeros(1, dtype=torch.bfloat16)
                        ) == 'akgm_tail_bf16'
    kernels = {'akgm_tail', 'conv3x3', 'conv1x1', 'gn1_stats',
               'akgm_tail_bwd', 'conv3x3_bwd', 'conv3x3_preact', 'akgm_mix',
               'akgm_packed'}
    assert _build.LAUNCHES.keys() == kernels | {
        k + '_bf16' for k in _build.BF16_KERNELS}
    assert set(_build.BF16_KERNELS) == {'akgm_tail', 'conv3x3', 'conv1x1',
                                        'gn1_stats', 'conv3x3_preact'}
