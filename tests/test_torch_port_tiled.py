"""The port's tiled high-resolution path (ucdir_tpu_torch.parallel.tiled,
eval_step with a tile dict) against the JAX package's on the CPU, and the
command line's few-step, tiled and search options.

Tolerance: the grid functions are exact; a tiled network evaluation 1e-4 abs
(dozens of layers per tile summed in other orders on the two sides); the
tiled validation step 1e-4 abs after 2 steps.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ucdir_tpu.models.dy3h import DY3h as JaxDY3h
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.parallel import tiled as jax_tiled
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train.step import make_eval_step
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch import eval as port_eval
from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
from ucdir_tpu_torch.diffusion import sampler as port_sampler
from ucdir_tpu_torch.eval import eval_step, should_tile
from ucdir_tpu_torch.models.dy3h import DY3h
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.parallel import tiled
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.utils import convert_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# (h, w, skip, padding): smaller than a tile, exact multiples of the shift,
# ragged, one axis below skip, the full-resolution Sony frame after its pad
GRID_CASES = [(48, 56, 64, 8), (100, 150, 64, 8), (96, 96, 64, 16),
              (64, 64, 64, 8), (192, 128, 64, 16), (40, 300, 128, 16),
              (2976, 4384, 1024, 64), (1552, 2256, 1024, 64)]


@pytest.mark.parametrize('h,w,skip,padding', GRID_CASES)
def test_tile_grid_equals_jax(h, w, skip, padding):
    pd = tiled._grid_pad(h, w, skip, padding)
    assert pd == jax_tiled._grid_pad(h, w, skip, padding)
    H, W = h + 2 * pd, w + 2 * pd
    starts = tiled.compute_tile_starts(H, W, skip, padding)
    assert starts == jax_tiled.compute_tile_starts(H, W, skip, padding)
    assert all(0 <= hs <= H - skip and 0 <= ws <= W - skip
               for hs, ws in starts)


def test_full_resolution_sony_frame_is_24_tiles():
    # 2848 x 4256 + the 64-px validation pad, then the 64-px tile pre-pad
    starts = tiled.compute_tile_starts(2976 + 128, 4384 + 128, 1024, 64)
    assert len(starts) == 24                       # 4 rows x 6 columns
    # the last two columns both snap to the end: the reference evaluates
    # those 4 tiles twice, and so do both packages
    assert len(set(starts)) == 20


@pytest.mark.parametrize('shape,skip,padding,chunk', [
    ((1, 100, 140, 6), 64, 16, 1), ((2, 48, 56, 6), 64, 8, 2),
    ((1, 100, 150, 6), 64, 8, 4)])
def test_patch_forward_guide_identity(rng, shape, skip, padding, chunk):
    """fn = the first 3 channels gives back the input, fn = the guide tile
    gives back the guide: tiles and guide tiles are cut in lockstep and every
    pixel is written by some tile's center."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape[:3] + (3,))
                         .astype(np.float32))
    kw = dict(skip=skip, padding=padding, tile_chunk=chunk)
    assert torch.equal(tiled.patch_forward_guide(lambda t, gt: t[..., :3], x,
                                                 g, **kw), x[..., :3])
    assert torch.equal(tiled.patch_forward_guide(lambda t, gt: gt, x, g, **kw),
                       g)


def test_patch_forward_guide_matches_jax(rng):
    """A function with a receptive field (a 3x3 mean) and overlapping,
    snapped tiles: the write order decides which tile's center wins."""
    x = rng.standard_normal((1, 100, 150, 3)).astype(np.float32)

    def mean3(t):
        p = torch.nn.functional.avg_pool2d(
            t.permute(0, 3, 1, 2), 3, stride=1, padding=1,
            count_include_pad=True)
        return p.permute(0, 2, 3, 1)

    def jmean3(t):
        k = jnp.tile(jnp.ones((3, 3, 1, 1), t.dtype) / 9., (1, 1, 1, 3))
        return jax.lax.conv_general_dilated(
            t, k, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'), feature_group_count=3)

    want = jax_tiled.patch_forward_guide(lambda t, g: jmean3(t),
                                         jnp.asarray(x), jnp.asarray(x),
                                         skip=64, padding=8)
    got = tiled.patch_forward_guide(lambda t, g: mean3(t),
                                    torch.from_numpy(x), torch.from_numpy(x),
                                    skip=64, padding=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


DY3H_CFG = dict(in_channel=6, out_channel=3, inner_channel=16,
                channel_mults=(1, 2), attn_res=(), res_blocks=1, dropout=0.0,
                norm_groups=1, image_size=64)


@pytest.mark.parametrize('chunk', [1, 4])
def test_tiled_denoise_fn_matches_jax(rng, chunk):
    """{skip: 64, padding: 8} on a 100 x 150 input: 3 x 4 overlapping tiles
    with hoisted guide maps, in chunks of 1 and of 4 tiles."""
    jm = JaxDY3h(**DY3H_CFG)
    z = np.zeros((1, 64, 64, 6), np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), z,
                              np.ones((1, 1), np.float32),
                              z[..., :3])['params']
    pm = DY3h(**DY3H_CFG).eval()
    out = {}
    convert_jax._dy3h(jax.tree_util.tree_map(np.asarray, params), '', out)
    pm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in out.items()}, strict=True)
    cond = rng.uniform(-1, 1, (1, 100, 150, 3)).astype(np.float32)
    guide = rng.uniform(-1, 1, (1, 100, 150, 3)).astype(np.float32)
    img = rng.standard_normal((1, 100, 150, 3)).astype(np.float32)
    nl = np.full((1, 1), 0.6, np.float32)
    want = jax.jit(lambda p: jax_tiled.tiled_denoise_fn(
        jm, p, jnp.asarray(cond), jnp.asarray(guide), skip=64, padding=8,
        tile_chunk=chunk)(jnp.asarray(img), jnp.asarray(nl)))(params)
    with torch.no_grad():
        fn = tiled.tiled_denoise_fn(pm, torch.from_numpy(cond),
                                    torch.from_numpy(guide), skip=64,
                                    padding=8, tile_chunk=chunk)
        got = fn(torch.from_numpy(img), torch.from_numpy(nl))
    assert got.shape == (1, 100, 150, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


TINY_UNET = dict(inner_channel=16, channel_mults=[1, 2], res_blocks=1,
                 attn_res=[], dropout=0.0)


def tiny_model_opt():
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(TINY_UNET)
    return model


def test_tiled_eval_step_matches_jax(rng, monkeypatch):
    """eval_step with a tile dict, 2 DDPM steps, against make_eval_step's
    reassembling path (the JAX package's tile-resident form of the same
    function is switched off)."""
    monkeypatch.setenv('UCDIR_TPU_NO_RESIDENT', '1')
    opt = {'model': tiny_model_opt()}
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=2)
    torch.manual_seed(0)
    model = define_G(opt).eval()
    params = convert_state_dict(model.state_dict())
    tile = {'skip': 64, 'padding': 8}
    sr = rng.uniform(-1, 1, (1, 40, 70, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    step = make_eval_step(jax_define_G(opt), jax_make_schedule(sched_opt),
                          pad=16, tile=tile)
    want_sr, want_initx = step({'params': params}, sr, key)
    shape = (1, 72, 102, 3)
    key, k0 = jax.random.split(key)
    draws = [np.array(jax.random.normal(k0, shape, np.float32))]
    for _ in range(2):   # the scan draws flat, the same numbers reshaped
        key, k = jax.random.split(key)
        draws.append(np.array(jax.random.normal(
            k, (shape[0] * shape[1], shape[2] * shape[3]), np.float32))
            .reshape(shape))
    it = iter(draws)
    got_sr, got_initx = eval_step(
        model, make_schedule(sched_opt), torch.from_numpy(sr), pad=16,
        tile=tile, noise=lambda s: torch.from_numpy(next(it)))
    assert got_sr.shape == (1, 40, 70, 3)
    np.testing.assert_allclose(got_initx.numpy(), np.asarray(want_initx),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_sr.numpy(), np.asarray(want_sr),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize('h,w,tile,want', [
    (1552, 2256, None, False),              # a SID frame: whole
    (2976, 4384, None, True),               # the full-resolution frame
    (2128, 2228, None, True),               # just above 4.3 M px
    (1024, 1024, {}, False),                # not above skip x skip
    (1025, 1024, {}, True),                 # strict, with a tile dict
    (72, 102, {'skip': 64}, True), (64, 64, {'skip': 64}, False)])
def test_should_tile(h, w, tile, want):
    assert should_tile(h, w, tile) is want


def test_large_inputs_take_the_tiled_path(monkeypatch):
    """Above the untiled limit eval_step hands super_resolution the default
    tile options, and super_resolution alone applies the same rule (DDPM on
    the reassembling path: tests/test_torch_port_resident.py takes the
    resident one)."""
    monkeypatch.setenv('UCDIR_TPU_NO_RESIDENT', '1')
    seen = []

    class Stop(Exception):
        pass

    def fake(denoiser, x_cond, guide, **kw):
        seen.append((tuple(x_cond.shape), kw))
        raise Stop                  # before any denoiser runs

    monkeypatch.setattr(tiled, 'tiled_denoise_fn', fake)
    monkeypatch.setattr(port_sampler, 'UNTILED_MAX_PX', 5000)
    monkeypatch.setattr(port_eval, 'UNTILED_MAX_PX', 5000)
    opt = {'model': tiny_model_opt()}
    opt['model']['unet'].update(inner_channel=8)
    model = define_G(opt).eval()
    sched = make_schedule(SID_VAL_SCHEDULE)
    x = torch.zeros(1, 1100, 1000, 3)       # above 1024 x 1024 once padded
    with pytest.raises(Stop):
        eval_step(model, sched, x, pad=16, generator=torch.Generator())
    with pytest.raises(Stop):
        port_sampler.super_resolution(model, sched, torch.zeros(1, 80, 80, 3),
                                      generator=torch.Generator())
    assert seen == [((1, 1132, 1032, 3),
                     dict(skip=1024, padding=64, tile_chunk=1,
                          distributed=False)),
                    ((1, 80, 80, 3), dict(skip=1024, padding=64,
                                          tile_chunk=1, distributed=False))]


# after sr.main: nothing of JAX or of the JAX package was imported
_CLI = (
    'import sys\n'
    'from ucdir_tpu_torch import sr\n'
    'sr.main(sys.argv[1:])\n'
    'bad = sorted(k for k in sys.modules if k.split(".")[0] in\n'
    '             ("ucdir_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))\n'
    'assert not bad, bad\n')


@pytest.fixture
def fixture_yaml(tmp_path):
    """sid-fixture.yaml on the checked-in pairs, with a toy-width denoiser
    (the shipped one is the full SID width, too heavy for a CPU test)."""
    with open(os.path.join(ROOT, 'ucdir_tpu', 'configs',
                           'sid-fixture.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['unet'].update(inner_channel=8, channel_mults=[1, 2],
                                res_blocks=1, attn_res=[], dropout=0.0)
    pairs = os.path.join(ROOT, 'dataset', 'fixture_pairs')
    roots = {'lq': pairs + '/input/', 'gt': pairs + '/target/'}
    for phase in ('train', 'val'):
        cfg['datasets'][phase]['data_args']['dataroot'] = roots
    (tmp_path / 'fixture.yaml').write_text(yaml.safe_dump(cfg))
    return tmp_path


def _cli(cwd, *args):
    proc = subprocess.run(
        [sys.executable, '-c', _CLI, '-p', 'val', '-c', 'fixture.yaml',
         '-debug', '--device', 'cpu', *args], cwd=cwd, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT,
                                         OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


def _results(cwd, suffix):
    return sorted(f for _, _, fs in os.walk(cwd) for f in fs
                  if f.endswith(suffix))


def test_cli_ddim_on_the_fixture_pairs(fixture_yaml):
    log = _cli(fixture_yaml, '--sampler', 'ddim', '--sampling_timesteps', '3')
    assert '# Validation # PSNR: ' in log and '# Validation # SSIM: ' in log
    assert [f[:4] for f in _results(fixture_yaml, '_sr.jpg')] == ['000_',
                                                                  '001_']


def test_cli_val_patch_on_the_fixture_pairs(fixture_yaml):
    # 96 x 96 inputs, 64-px tiles with 8-px halos: 3 x 3 reverse processes
    log = _cli(fixture_yaml, '--val_patch', '--patch_skip', '64',
               '--patch_padding', '8', '--sampler', 'ddim',
               '--sampling_timesteps', '2')
    assert '# val_patch # PSNR: ' in log
    assert [f[:4] for f in _results(fixture_yaml, '_sr.jpg')] == ['000_',
                                                                  '001_']


def test_cli_search_params_on_the_fixture_pairs(fixture_yaml):
    log = _cli(fixture_yaml, '--search_params', '--search_steps', '2,3',
               '--search_ends', '0.2')
    assert '# search steps=2 linear_end=0.20 PSNR: ' in log
    assert '# search steps=3 linear_end=0.20 PSNR: ' in log
    assert _results(fixture_yaml, '_sr.jpg') == [
        's2_e0.2_1_sr.jpg', 's2_e0.2_2_sr.jpg', 's3_e0.2_1_sr.jpg',
        's3_e0.2_2_sr.jpg']
