"""`sr.main` on the CPU for a config of SR3's network (GaussianDiffusion
with `resname: ResnetBlock`), train then validate, with nothing of JAX or of
the JAX package imported. The models themselves are held against the JAX
package in test_torch_port_families.py."""
import os
import subprocess
import sys

import torch
import yaml

from test_torch_port_families import SR3
from test_torch_port_slice import _write_pairs
from test_torch_port_train import _CLI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, *args):
    proc = subprocess.run(
        [sys.executable, '-c', _CLI, '-c', 'sr3.yaml', '-debug', '--device',
         'cpu', *args], cwd=tmp_path, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=ROOT,
                              OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


def test_cli_trains_and_validates_an_sr3_config_loads_no_jax(tmp_path):
    """A GaussianDiffusion + ResnetBlock (norm_groups 8, l2) config through
    `-p train` (3 iterations; -debug saves at the third) and `-p val` of
    what it saved, on the CPU:
    no predictor, so the `_inf` image is the degraded input; nothing of JAX
    or of the JAX package imported."""
    data = str(tmp_path / 'data')
    _write_pairs(data)
    with open(os.path.join(ROOT, 'ucdir_tpu', 'configs', 'sid.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['name'] = 'sid-sr3'
    cfg['model']['diffusion_name'] = 'GaussianDiffusion'
    cfg['model']['diffusion']['loss_type'] = 'l2'
    cfg['model']['unet'].update(inner_channel=8, channel_mults=[1, 2],
                                res_blocks=1, attn_res=[], **SR3)
    roots = {'lq': data + '/input', 'gt': data + '/target'}
    for phase in ('train', 'val'):
        cfg['datasets'][phase]['data_args']['dataroot'] = roots
    cfg['datasets']['train']['data_args']['crop_size'] = 32
    cfg['train']['n_iter'] = 3
    (tmp_path / 'sr3.yaml').write_text(yaml.safe_dump(cfg))
    log = _cli(tmp_path, '-p', 'train')
    assert log.count('l_pix: ') == 1 and 'End of training.' in log
    prefix = [os.path.join(d, 'I_Elatest') for d, _, fs in os.walk(tmp_path)
              if 'I_Elatest_gen_ema.pth' in fs][0]
    sd = torch.load(prefix + '_gen_ema.pth', weights_only=True)
    assert not any(k.startswith('predictor.') for k in sd)
    assert 'denoise_fn.downs.1.res_block.block1.block.3.weight' in sd
    log = _cli(tmp_path, '-p', 'val', '--checkpoint', prefix)
    assert '# Validation # PSNR: ' in log
    inf = [f for _, _, fs in os.walk(tmp_path) for f in fs
           if f.endswith('_inf.png')]
    assert len(inf) == 2, inf
