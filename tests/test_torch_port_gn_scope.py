"""Tile-scoped GroupNorm(1) (UCDIR_TPU_GN_SCOPE=tile, ucdir_tpu_torch/ops/
gn_scope.py) against the JAX package's on the CPU: `tile_gn`, the window
rule, and the tiny restoration with the scope engaged in every norm site
(the AKGM block, SR3's Block, attention, the head).

Tolerances: `tile_gn` 1e-6 abs on unit-variance inputs (as the JAX
package's own test draws them) with windows of up to 8 x 8 x 8 values; on
windows of 4096 and more the JAX package's float32 sums stray further from
float64 (3.2e-6 at 16 x 16 x 16, 6.6e-6 at 16 x 16 x 64), so there the port
is held within 1e-6 of float64 and within the JAX package's own distance
from it (plus 1e-6) of the JAX package; the window rule exact; the
validation step 1e-4 abs after 2 steps, as tests/test_torch_port_tiled.py
holds the whole step.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.ops import gn_scope as jax_gn_scope
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train.step import make_eval_step
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
from ucdir_tpu_torch.eval import eval_step
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.ops import gn_scope
from ucdir_tpu_torch.schedule import make_schedule

torch.set_num_threads(2)


def _operands(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, scale, bias


def _both(x, scale, bias, win):
    want = jax_gn_scope.tile_gn(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias), win)
    got = gn_scope.tile_gn(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), win)
    assert got.dtype == torch.float32 and got.shape == x.shape
    return got.numpy(), np.asarray(want)


def _float64(x, scale, bias, win):
    """GroupNorm(1) per window in float64, window by window."""
    y = np.empty(x.shape, np.float64)
    for i in range(0, x.shape[1], win):
        for j in range(0, x.shape[2], win):
            blk = x[:, i:i + win, j:j + win].astype(np.float64)
            m = blk.mean(axis=(1, 2, 3), keepdims=True)
            v = blk.var(axis=(1, 2, 3), keepdims=True)
            y[:, i:i + win, j:j + win] = (blk - m) / np.sqrt(v + 1e-5)
    return y * scale + bias


@pytest.mark.parametrize('shape,win', [
    ((2, 16, 16, 4), 4), ((1, 20, 28, 8), 8), ((1, 9, 7, 3), 4),
    ((2, 13, 11, 8), 4), ((1, 8, 8, 5), 8)])
def test_tile_gn_matches_jax(rng, shape, win):
    """Exact and ragged windows (their true counts), one-window maps."""
    x, scale, bias = _operands(rng, shape)
    got, want = _both(x, scale, bias, win)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _float64(x, scale, bias, win),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize('shape,win', [((2, 33, 17, 16), 16),
                                       ((1, 40, 36, 64), 16)])
def test_tile_gn_large_windows(rng, shape, win):
    """Windows of 16 x 16 x 16 and 16 x 16 x 64 values, ragged: within
    1e-6 of float64, and of the JAX package within its own distance from
    float64."""
    x, scale, bias = _operands(rng, shape)
    got, want = _both(x, scale, bias, win)
    ref = _float64(x, scale, bias, win)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want,
                               atol=np.abs(want - ref).max() + 1e-6, rtol=0)


def test_gn_tile_window_equals_jax(monkeypatch):
    """On a grid of canvases, feature maps at every downscale up to /16 and
    three window sizes: the same window, or None, as the JAX package's
    rule under gn_canvas."""
    monkeypatch.setenv('UCDIR_TPU_GN_SCOPE', 'tile')
    n = 0
    for tile in (64, 100, 1024):
        monkeypatch.setenv('UCDIR_TPU_GN_TILE', str(tile))
        for H, W in ((96, 128), (160, 160), (1568, 2272), (1152, 1152),
                     (2048, 2048), (3104, 4512)):
            with jax_gn_scope.gn_canvas(H, W):
                for k in (1, 2, 4, 8, 16):
                    h, w = -(-H // k), -(-W // k)
                    want = jax_gn_scope.gn_tile_window(h, w)
                    assert gn_scope.gn_tile_window((H, W), h, w, tile) \
                        == want, (tile, H, W, k)
                    n += want is not None
    assert n > 0
    assert gn_scope.gn_scope_from_env() == ('tile', 1024)
    monkeypatch.setenv('UCDIR_TPU_GN_SCOPE', 'windows')
    with pytest.raises(ValueError, match='UCDIR_TPU_GN_SCOPE'):
        gn_scope.gn_scope_from_env()


def _opt(resname):
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(inner_channel=8, channel_mults=[1, 2],
                         res_blocks=1, attn_res=[], dropout=0.0,
                         resname=resname)
    return {'model': model}


def _jax_draws(key, shape, steps):
    """The draws of the JAX package's DDPM scan for `key`: the initial
    state, then one flat draw a step, reshaped."""
    key, k0 = jax.random.split(key)
    draws = [np.array(jax.random.normal(k0, shape, np.float32))]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(np.array(jax.random.normal(
            k, (shape[0] * shape[1], shape[2] * shape[3]), np.float32))
            .reshape(shape))
    return draws


@pytest.mark.parametrize('resname', ['ResnetBlockDY3h', 'ResnetBlock'])
def test_tile_scope_restoration_matches_jax(rng, monkeypatch, resname):
    """A 40 x 70 input, 16-px pad, 2 DDPM steps through the validation step,
    UCDIR_TPU_GN_SCOPE=tile and UCDIR_TPU_GN_TILE=32 on both sides (the
    96 x 128 canvas windowed at every level, the mid block's attention
    too), against make_eval_step; and away from the canvas scope's result,
    so the windows did engage."""
    monkeypatch.setenv('UCDIR_TPU_GN_SCOPE', 'tile')
    monkeypatch.setenv('UCDIR_TPU_GN_TILE', '32')
    opt = _opt(resname)
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=2)
    torch.manual_seed(1)
    model = define_G(opt).eval()
    assert (model.denoise_fn.gn_scope, model.denoise_fn.gn_tile) == ('tile',
                                                                     32)
    params = convert_state_dict(model.state_dict())
    sr = rng.uniform(-1, 1, (1, 40, 70, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = make_eval_step(jax_define_G(opt), jax_make_schedule(sched_opt),
                          pad=16)({'params': params}, sr, key)[0]
    draws = _jax_draws(key, (1, 72, 102, 3), 2)

    def restore(m):
        it = iter(draws)
        return eval_step(m, make_schedule(sched_opt), torch.from_numpy(sr),
                         pad=16, noise=lambda s: torch.from_numpy(next(it))
                         )[0].numpy()

    got = restore(model)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    model.denoise_fn.gn_scope = 'canvas'
    assert np.abs(restore(model) - got).max() > 1e-4


def test_canvas_within_a_window_keeps_the_folded_path(monkeypatch):
    """A map within 1.5 windows keeps the canvas scope: with a window as
    large as the canvas the tile scope gives the canvas scope's bits (the
    tiled path's tiles run their usual kernels with the switch set)."""
    monkeypatch.setenv('UCDIR_TPU_GN_SCOPE', 'tile')
    opt = _opt('ResnetBlockDY3h')
    torch.manual_seed(1)
    model = define_G(opt).eval()
    assert model.denoise_fn.gn_tile == 1024
    x = torch.rand(1, 64, 96, 6) * 2 - 1
    nl = torch.full((1, 1), 0.5)
    with torch.no_grad():
        tile = model.denoise_fn(x, nl, x[..., :3])
        model.denoise_fn.gn_scope = 'canvas'
        canvas = model.denoise_fn(x, nl, x[..., :3])
    assert torch.equal(tile, canvas)
