"""The port's SID validation slice against the JAX package's, end to end on
the CPU: the same random weights (the port's, through convert_torch), the
same input, and the JAX sampler's own threefry draws injected into the port.
Also checkpoint loading, the port's CLI, and that the port imports no JAX.

Tolerance of the slice: 1e-4 abs on outputs in [-1, 1] after 3 steps (the
per-network differences of test_torch_port_modules, carried through the
reverse process).
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax

from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train.step import make_eval_step
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
from ucdir_tpu_torch.eval import eval_step
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.schedule import make_schedule

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# attn_res empty: the one attention layer is mid_0's, at /2 (streamed)
TINY_UNET = dict(inner_channel=16, channel_mults=[1, 2], res_blocks=1,
                 attn_res=[])


def tiny_model_opt():
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(TINY_UNET)
    return model


def jax_draws(key, shape, T):
    """The draws of ucdir_tpu's p_sample_loop for `key`: the initial one,
    then one per step (flat in the scan, the same numbers reshaped)."""
    key, k0 = jax.random.split(key)
    draws = [np.array(jax.random.normal(k0, shape, np.float32))]
    flat = (shape[0] * shape[1], shape[2] * shape[3])
    for _ in range(T):
        key, k = jax.random.split(key)
        draws.append(np.array(jax.random.normal(k, flat, np.float32))
                     .reshape(shape))
    return draws


def test_slice_matches_jax_eval_step(rng):
    opt = {'model': tiny_model_opt()}
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=3)
    torch.manual_seed(0)
    model = define_G(opt).eval()
    # the port's random weights, as JAX params (the mapping is exact both
    # ways: test_torch_port_modules' round trip)
    params = convert_state_dict(model.state_dict())
    jm = jax_define_G(opt)
    sr = rng.uniform(-1, 1, (1, 80, 80, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    step = make_eval_step(jm, jax_make_schedule(sched_opt), pad=64,
                          continous=True)
    want_sr, want_initx, want_snaps = step({'params': params}, sr, key)

    draws = iter(jax_draws(key, (1, 208, 208, 3), 3))
    got_sr, got_initx, got_snaps = eval_step(
        model, make_schedule(sched_opt), torch.from_numpy(sr),
        continous=True, noise=lambda shape: torch.from_numpy(next(draws)))

    assert got_sr.shape == (1, 80, 80, 3)
    assert got_snaps.shape == np.asarray(want_snaps).shape == (4, 1, 80, 80, 3)
    np.testing.assert_allclose(got_initx.numpy(), np.asarray(want_initx),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_sr.numpy(), np.asarray(want_sr),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_snaps.numpy(), np.asarray(want_snaps),
                               atol=1e-4, rtol=0)


def test_untiled_limit_refuses_larger_inputs(monkeypatch):
    """Above the untiled limit the whole-image path refuses the input: it
    goes to the tiled denoiser (1024-px tiles, 64-px halos) instead."""
    from ucdir_tpu_torch.parallel import tiled

    class Tiled(Exception):
        pass

    def fake(denoiser, x_cond, guide, **kw):
        assert tuple(x_cond.shape) == (1, 2128, 2228, 3)
        assert kw == dict(skip=1024, padding=64, tile_chunk=1)
        raise Tiled

    monkeypatch.setattr(tiled, 'tiled_denoise_fn', fake)
    model = define_G({'model': tiny_model_opt()})
    x = torch.zeros(1, 2000, 2100, 3)    # 2128 x 2228 padded > 4.3 M px
    with pytest.raises(Tiled):
        eval_step(model, make_schedule(SID_VAL_SCHEDULE), x,
                  generator=torch.Generator())


def test_trainer_loads_a_reference_checkpoint(tmp_path):
    """<prefix>_gen_ema.pth with the reference's schedule buffers beside
    the weights loads with strict=True; a missing file is an error."""
    from ucdir_tpu_torch.trainer import SCHEDULE_BUFFERS, Trainer
    torch.manual_seed(1)
    sd = dict(define_G({'model': tiny_model_opt()}).state_dict())
    sd.update({k: torch.zeros(3) for k in SCHEDULE_BUFFERS})
    torch.save(sd, tmp_path / 'I_Elatest_gen_ema.pth')
    opt = {'phase': 'val', 'model': tiny_model_opt(),
           'path': {'resume_state': str(tmp_path / 'I_Elatest')},
           'train': {'ema_scheduler': {'use': True}}}
    trainer = Trainer(opt, device='cpu')
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    opt['path']['resume_state'] = str(tmp_path / 'missing')
    with pytest.raises(FileNotFoundError):
        Trainer(opt, device='cpu')


def _write_pairs(root, n=2, size=40):
    g = np.random.default_rng(0)
    for sub in ('input', 'target'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        clean = g.integers(0, 256, (size, size, 3), dtype=np.uint8)
        noisy = np.clip(clean + g.normal(0, 25, clean.shape), 0, 255)
        Image.fromarray(clean).save(os.path.join(root, 'target', f'{i}.png'))
        Image.fromarray(noisy.astype(np.uint8)).save(
            os.path.join(root, 'input', f'{i}.png'))


def test_cli_val_on_cpu(tmp_path):
    data = str(tmp_path / 'data')
    _write_pairs(data)
    with open(os.path.join(ROOT, 'ucdir_tpu', 'configs', 'sid.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['name'] = 'sid-tiny'
    cfg['model']['unet'].update(inner_channel=8, channel_mults=[1, 2],
                                res_blocks=1, attn_res=[])
    roots = {'lq': data + '/input', 'gt': data + '/target'}
    for phase in ('train', 'val'):
        cfg['datasets'][phase]['data_args']['dataroot'] = roots
    (tmp_path / 'tiny.yaml').write_text(yaml.safe_dump(cfg))
    # -debug: 10 val steps instead of 50
    proc = subprocess.run(
        [sys.executable, '-m', 'ucdir_tpu_torch.sr', '-p', 'val', '-c',
         'tiny.yaml', '-debug', '--device', 'cpu'],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '# Validation # PSNR: ' in proc.stderr
    assert '# Validation # SSIM: ' in proc.stderr
    results = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
               for f in fs if f.endswith('_sr.jpg')]
    assert len(results) == 2


def test_cli_refuses_what_is_not_ported():
    from ucdir_tpu_torch import sr
    for argv in (['-p', 'val', '--val_batch', '2'],
                 ['-p', 'train', '--compute_dtype', 'bf16']):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            sr.main(argv + ['--device', 'cpu'])
    # what the port carries by now is refused no longer
    args = sr._parser().parse_args(
        ['--sampler', 'dpmpp_sde', '--sampling_timesteps', '4', '--val_patch',
         '--patch_skip', '64', '--patch_padding', '8', '--search_params',
         '--search_steps', '2,3', '--search_ends', '0.2',
         '--compute_dtype', 'bf16'])
    sr._refuse(args)


def test_port_imports_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import ucdir_tpu_torch\n'
        'for m in pkgutil.walk_packages(ucdir_tpu_torch.__path__,\n'
        '                               "ucdir_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [k for k in sys.modules if k.split(".")[0] in\n'
        '       ("ucdir_tpu", "jax", "jaxlib", "flax", "optax", "orbax")]\n'
        'assert not bad, bad\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sid_model_equals_sid_yaml():
    with open(os.path.join(ROOT, 'ucdir_tpu', 'configs', 'sid.yaml')) as f:
        assert yaml.safe_load(f)['model'] == SID_MODEL


def test_chip_smoke_refuses_to_run_without_cuda():
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
