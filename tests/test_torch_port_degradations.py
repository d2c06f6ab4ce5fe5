"""The port's degradation ops (ucdir_tpu_torch.data.degradations, diffjpeg)
on the CPU against the JAX package's, on the same inputs:

  filter2D, usm_sharp, interpolate   rtol 1e-4, atol 1e-5 (float32 sums in
                                     other orders);
  the `_pt` noises                   1e-6 abs, on the JAX function's draws
                                     re-derived from its key by the same
                                     jax.random calls and passed to the port;
  DiffJPEG, differentiable and hard  2e-3 abs, the JAX package's own limit
                                     against the reference's DiffJPEG (a
                                     coefficient rounded the other way
                                     would move a value by a whole
                                     quantization step);
  the host half                      bit for bit (the same numpy code).
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucdir_tpu.data import degradations as JD
from ucdir_tpu.data import diffjpeg as JJ
from ucdir_tpu_torch.data import degradations as PD
from ucdir_tpu_torch.data import diffjpeg as PJ

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=1e-4, atol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def jax_gaussian_draws(key, img, sigma_range):
    """The draws of the JAX `random_add_gaussian_noise_pt(key, img, ...)`,
    as the port's draws dict."""
    b = img.shape[0]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {k: _t(v) for k, v in (
        ('sigma', jax.random.uniform(k1, (b, 1, 1, 1), jnp.float32,
                                     sigma_range[0], sigma_range[1])),
        ('gray', jax.random.uniform(k2, (b, 1, 1, 1), jnp.float32)),
        ('noise', jax.random.normal(k3, img.shape, jnp.float32)),
        ('noise_gray', jax.random.normal(k4, img.shape[:3] + (1,),
                                         jnp.float32)))}


@jax.jit
def _jax_counts(k, x):
    xr = jnp.round(jnp.clip(x * 255., 0, 255)) / 255.
    vals = JD._unique_vals_pow2(xr).reshape(x.shape[0], 1, 1, 1)
    return jax.random.poisson(k, xr * vals).astype(jnp.float32)


def jax_poisson_draws(key, img, scale_range):
    """The draws of the JAX `random_add_poisson_noise_pt(key, img, ...)`:
    its uniforms, and its Poisson counts at the rates of `img` (numpy)."""
    b = img.shape[0]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    x = jnp.asarray(img, jnp.float32)
    gray = jnp.broadcast_to(JD._rgb_to_gray(x), x.shape)
    return {k: _t(v) for k, v in (
        ('scale', jax.random.uniform(k1, (b, 1, 1, 1), jnp.float32,
                                     scale_range[0], scale_range[1])),
        ('gray', jax.random.uniform(k2, (b, 1, 1, 1), jnp.float32)),
        ('counts', _jax_counts(k3, x)), ('counts_gray', _jax_counts(k4, gray)))}


@pytest.mark.parametrize('shape, k, per_sample', [
    ((2, 24, 30, 3), 21, True), ((3, 17, 23, 3), 7, True),
    ((2, 24, 30, 3), 15, False), ((1, 40, 33, 1), 11, False)])
def test_filter2d_matches(rng, shape, k, per_sample):
    img = rng.random(shape).astype(np.float32)
    ker = rng.random((shape[0] if per_sample else 1, k, k)).astype(np.float32)
    ker /= ker.sum(axis=(1, 2), keepdims=True)
    _close(PD.filter2D(_t(img), _t(ker)),
           JD.filter2D(jnp.asarray(img), jnp.asarray(ker)))
    with pytest.raises(ValueError, match='kernel size'):
        PD.filter2D(_t(img), _t(ker[:, :-1, :-1]))


@pytest.mark.parametrize('radius', [15, 50])
def test_usm_sharp_matches(rng, radius):
    img = rng.random((2, 60, 52, 3)).astype(np.float32)
    _close(PD.usm_sharp(_t(img), radius=radius),
           JD.usm_sharp(jnp.asarray(img), radius=radius))
    np.testing.assert_array_equal(PD.gaussian_kernel_2d(radius),
                                  JD.gaussian_kernel_2d(radius))


@pytest.mark.parametrize('mode', ['area', 'bilinear', 'bicubic'])
@pytest.mark.parametrize('scale', [0.37, 0.5, 1.5, 4])
def test_interpolate_scale_matches(rng, mode, scale):
    """As tests/test_realsr.py holds the JAX function to F.interpolate:
    the port's is F.interpolate, given the caller's scale_factor."""
    x = rng.standard_normal((2, 17, 23, 3)).astype(np.float32)
    got = PD.interpolate(_t(x), scale_factor=scale, mode=mode)
    want = JD.interpolate(jnp.asarray(x), scale_factor=scale, mode=mode)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize('mode, size', [('bicubic', (21, 45)),
                                        ('bilinear', (9, 9)),
                                        ('area', (13, 29)),
                                        ('bilinear', (32, 32)),
                                        ('area', (32, 32))])
def test_interpolate_size_matches(rng, mode, size):
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    _close(PD.interpolate(_t(x), size=size, mode=mode),
           JD.interpolate(jnp.asarray(x), size=size, mode=mode))


@pytest.mark.parametrize('gray_prob', [0.0, 0.5, 1.0])
@pytest.mark.parametrize('clip, rounds', [(True, False), (True, True),
                                          (False, False)])
def test_gaussian_noise_pt_matches_on_jax_draws(rng, gray_prob, clip,
                                                rounds):
    img = rng.random((4, 12, 10, 3)).astype(np.float32)
    key = jax.random.PRNGKey(int(gray_prob * 10) + 3 * clip + rounds)
    want = JD.random_add_gaussian_noise_pt(
        key, jnp.asarray(img), sigma_range=(1, 30), gray_prob=gray_prob,
        clip=clip, rounds=rounds)
    got = PD.random_add_gaussian_noise_pt(
        _t(img), sigma_range=(1, 30), gray_prob=gray_prob, clip=clip,
        rounds=rounds, draws=jax_gaussian_draws(key, img, (1, 30)))
    _close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('gray_prob', [0.0, 0.5, 1.0])
@pytest.mark.parametrize('clip, rounds', [(True, False), (True, True),
                                          (False, False)])
def test_poisson_noise_pt_matches_on_jax_draws(rng, gray_prob, clip, rounds):
    img = rng.random((4, 12, 10, 3)).astype(np.float32)
    img[1] = np.round(img[1] * 7) / 7      # few levels: a small vals
    key = jax.random.PRNGKey(11 + int(gray_prob * 10) + 3 * clip + rounds)
    want = JD.random_add_poisson_noise_pt(
        key, jnp.asarray(img), scale_range=(0.05, 3), gray_prob=gray_prob,
        clip=clip, rounds=rounds)
    got = PD.random_add_poisson_noise_pt(
        _t(img), scale_range=(0.05, 3), gray_prob=gray_prob, clip=clip,
        rounds=rounds, draws=jax_poisson_draws(key, img, (0.05, 3)))
    _close(got, want, rtol=0, atol=1e-6)


def test_unique_vals_pow2_matches(rng):
    img = rng.random((3, 20, 20, 3)).astype(np.float32)
    img[0] = 0.5
    img[1] = np.round(img[1] * 5) / 5
    np.testing.assert_array_equal(
        PD._unique_vals_pow2(_t(img)).numpy(),
        np.asarray(JD._unique_vals_pow2(jnp.asarray(img))))


@pytest.mark.parametrize('which', ['gaussian', 'poisson'])
def test_noise_draws_come_from_the_generator(rng, which):
    """Without draws the noise comes from `generator` alone: the same seed
    gives the same output, another seed another, and the noise has the
    size its range gives."""
    img = _t(rng.random((2, 16, 16, 3)) * 0.5 + 0.25)
    fn = getattr(PD, 'random_add_%s_noise_pt' % which)
    rng_kw = ({'sigma_range': (20, 20)} if which == 'gaussian'
              else {'scale_range': (1, 1)})

    def run(seed):
        return fn(img, gray_prob=0.5, clip=False,
                  generator=torch.Generator().manual_seed(seed), **rng_kw)
    a = run(1)
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    std = float((a - img).std())
    assert 0.03 < std < 0.15, std


@pytest.mark.parametrize('shape', [(2, 32, 48, 3), (2, 40, 56, 3),
                                   (1, 33, 47, 3)])
@pytest.mark.parametrize('quality', ['scalar', 'per_sample'])
@pytest.mark.parametrize('differentiable', [False, True])
def test_diffjpeg_matches(rng, shape, quality, differentiable):
    x = rng.random(shape).astype(np.float32)
    q = (37.5 if quality == 'scalar'
         else np.linspace(20., 80., shape[0]).astype(np.float32))
    want = jax.jit(lambda x, q: JJ.diff_jpeg(
        x, q, differentiable=differentiable))(jnp.asarray(x), jnp.asarray(q))
    got = PJ.diff_jpeg(_t(x), torch.as_tensor(q),
                       differentiable=differentiable)
    assert got.shape == x.shape
    _close(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(float(PJ.quality_to_factor(10)), 5.0)
    np.testing.assert_allclose(float(PJ.quality_to_factor(95)), 0.1,
                               atol=1e-6)


def test_diffjpeg_gradients_match(rng):
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    want = jax.jit(jax.grad(lambda v: jnp.sum(JJ.diff_jpeg(v, 50.))))(
        jnp.asarray(x))
    t = _t(x).requires_grad_(True)
    PJ.diff_jpeg(t, 50.).sum().backward()
    assert torch.isfinite(t.grad).all() and float(t.grad.abs().max()) > 0
    _close(t.grad, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize('kernel_type', ['iso', 'aniso', 'generalized_iso',
                                         'generalized_aniso', 'plateau_iso',
                                         'plateau_aniso'])
def test_host_kernels_equal(kernel_type):
    for size in (7, 21):
        for mod in (JD, PD):
            random.seed(4), np.random.seed(4)
            mod.out = mod.random_mixed_kernels(
                [kernel_type], [1.], size, (0.2, 3), (0.2, 3),
                (-np.pi, np.pi), (0.5, 4), (1, 2))
        np.testing.assert_array_equal(PD.out, JD.out)
        del PD.out, JD.out
    np.testing.assert_array_equal(PD.circular_lowpass_kernel(1.3, 13, 21),
                                  JD.circular_lowpass_kernel(1.3, 13, 21))


@pytest.mark.parametrize('fn, kw', [
    ('random_add_gaussian_noise', {'sigma_range': (1, 30), 'gray_prob': 0.4}),
    ('random_add_poisson_noise', {'scale_range': (0.05, 3),
                                  'gray_prob': 0.4}),
    ('random_add_speckle_noise', {'speckle_std': (1, 20)}),
    ('random_add_saltpepper_noise', {'amount': (0.01, 0.1),
                                     'svsp': (0.3, 0.7)}),
    ('random_add_screen_noise', {}),
    ('random_add_jpg_compression', {'quality_range': (30, 95)})])
def test_host_noises_equal(rng, fn, kw):
    img = rng.random((20, 24, 3)).astype(np.float32)
    outs = []
    for mod in (JD, PD):
        for seed in (0, 1):
            np.random.seed(seed)
            outs.append(getattr(mod, fn)(img.copy(), **kw))
    for g, w in zip(outs[2:], outs[:2]):
        np.testing.assert_array_equal(g, w)
