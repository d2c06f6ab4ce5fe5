"""Validation at a batch above 1 on the CPU: the port's eval_step at B = 2
against the JAX package's make_eval_step at B = 2 (no mesh, the same
weights and the JAX sampler's draws injected), and `sr.main -p val
--val_batch 2`, which restores, saves and scores every image of a batch.

Tolerance: the validation slice's 1e-4 abs after 3 steps
(tests/test_torch_port_slice.py).
"""
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train.step import make_eval_step
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
from ucdir_tpu_torch.eval import eval_step
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.schedule import make_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
from test_torch_port_slice import (_write_pairs, jax_draws,  # noqa: E402
                                   tiny_model_opt)

torch.set_num_threads(2)


def test_batch_of_two_matches_jax_eval_step(rng):
    """Two different images in one batch, 3 steps: initx, the result and
    every snapshot within 1e-4 of the JAX package's at the same batch."""
    opt = {'model': tiny_model_opt()}
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=3)
    torch.manual_seed(0)
    model = define_G(opt).eval()
    params = convert_state_dict(model.state_dict())
    sr = rng.uniform(-1, 1, (2, 80, 80, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    step = make_eval_step(jax_define_G(opt), jax_make_schedule(sched_opt),
                          pad=64, continous=True)
    want = step({'params': params}, sr, key)

    draws = iter(jax_draws(key, (2, 208, 208, 3), 3))
    got = eval_step(model, make_schedule(sched_opt), torch.from_numpy(sr),
                    continous=True,
                    noise=lambda shape: torch.from_numpy(next(draws)))
    assert got[0].shape == (2, 80, 80, 3)
    assert got[2].shape == np.asarray(want[2]).shape == (4, 2, 80, 80, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


def test_cli_val_batch_scores_every_image(tmp_path, monkeypatch):
    """`sr.main -p val --val_batch 2` on 4 equal-size pairs: one result
    set under each image's own name, and the mean it returns and logs is
    the mean of the 4 per-image PSNRs."""
    from ucdir_tpu_torch import sr
    from ucdir_tpu_torch.metrics import core as Metrics

    data = str(tmp_path / 'data')
    n = 4
    _write_pairs(data, n=n, size=32)
    with open(os.path.join(ROOT, 'ucdir_tpu', 'configs', 'sid.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['name'] = 'sid-tiny'
    # three levels: mid_0's attention at /4 (40 x 40 of the padded input)
    cfg['model']['unet'].update(inner_channel=8, channel_mults=[1, 2, 2],
                                res_blocks=1, attn_res=[])
    roots = {'lq': data + '/input', 'gt': data + '/target'}
    for phase in ('train', 'val'):
        cfg['datasets'][phase]['data_args']['dataroot'] = roots
    (tmp_path / 'tiny.yaml').write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    psnrs, psnr = [], Metrics.calculate_psnr

    def record(a, b):
        psnrs.append(psnr(a, b))
        return psnrs[-1]

    monkeypatch.setattr(Metrics, 'calculate_psnr', record)
    # -debug: 10 validation steps instead of 50
    avg_psnr, _ = sr.main(['-p', 'val', '-c', 'tiny.yaml', '-debug',
                           '--device', 'cpu', '--val_batch', '2'])
    assert len(psnrs) == n
    assert avg_psnr == pytest.approx(sum(psnrs) / n, rel=1e-12)
    names = sorted(f for _, _, fs in os.walk(tmp_path / 'experiments')
                   for f in fs if f.endswith('.jpg'))
    assert names == sorted('%d_val_debug_sid-tiny-ema_%s.jpg' % (i, kind)
                           for i in range(n)
                           for kind in ('hr', 'inf', 'lr', 'sr'))


class _Stub:
    """A trainer whose restoration is a fixed function of its input."""

    def feed_data(self, data):
        self.data = {k: np.asarray(v) for k, v in data.items()}

    def test(self, continous=False):
        self.SR = np.tanh(0.7 * self.data['SR'] + 0.1)

    def get_current_visuals(self):
        return {'SR': self.SR, 'HR': self.data['HR']}

    def set_new_noise_schedule(self, *args, **kwargs):
        pass


@pytest.mark.parametrize('loop', ['val_patch', 'search_params'])
def test_alternative_loops_take_a_batch_as_the_jax_package_does(
        rng, tmp_path, caplog, loop):
    """`val_patch` and `search_params` at --val_batch 2 do what the JAX
    package's sr.py does with a batch: restore it as one, score and save
    it as one grid image (val_patch under its first image's name), log the
    same means; the port's and the JAX package's loops, given the same
    trainer and batches, write the same files and log the same lines."""
    import logging
    import sr as jax_sr
    from ucdir_tpu_torch import sr as port_sr
    from ucdir_tpu_torch.metrics import core as Metrics

    batches = [{'SR': rng.uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32),
                'HR': rng.uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32),
                'Index': np.array([2 * i, 2 * i + 1])} for i in range(2)]
    val_set = type('Set', (), {'sr_path': ['img%d.png' % i
                                           for i in range(4)]})()
    logged, files = {}, {}
    for name, mod in (('jax', jax_sr), ('port', port_sr)):
        opt = {'name': 'sid-tiny', 'path': {'results': str(tmp_path / name)},
               'model': {'beta_schedule': {'val': dict(SID_VAL_SCHEDULE)}}}
        logger = logging.getLogger('valbatch_' + name)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger.name):
            if loop == 'val_patch':
                mod.val_patch(opt, batches, val_set, _Stub(), Metrics, logger,
                              skip=32, padding=8)
            else:
                mod.search_params(opt, batches, _Stub(), Metrics, logger,
                                  n_timesteps=(2,), linear_ends=(0.2, 0.4))
        logged[name] = caplog.messages
        files[name] = sorted(os.listdir(tmp_path / name))
    assert logged['port'] == logged['jax'] and logged['port']
    assert files['port'] == files['jax']
    if loop == 'val_patch':
        assert files['port'] == ['img0_sid-tiny_hr.jpg', 'img0_sid-tiny_sr.jpg',
                                 'img2_sid-tiny_hr.jpg', 'img2_sid-tiny_sr.jpg']


def test_a_batch_of_two_sizes_is_refused():
    """The images of one validation batch must share one size: the loader
    says so rather than failing inside np.stack."""
    from ucdir_tpu_torch.data import create_dataloader

    class Items:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return {'Index': i, 'SR': np.zeros((8 + i, 8, 3), np.float32)}

    loader = create_dataloader(Items(), {'val_batch': 2}, 'val')
    with pytest.raises(ValueError, match='one size'):
        next(iter(loader))
