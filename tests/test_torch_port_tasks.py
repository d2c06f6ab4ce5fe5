"""The port's restoration tasks beyond SID through its CLI on the CPU:
`python -m ucdir_tpu_torch.sr -p val` on narrowed copies of
ucdir_tpu/configs/gop-deblur.yaml and jpg-restore.yaml (inner 8, mults 1-2,
no attention, 48 px generated files; config.parse's per-task validation
overrides), and `-p train` for 2 steps of jpg-restore and of a DDPM_realsr
configuration; after each, nothing of ucdir_tpu, jax or flax is in
sys.modules (as tests/test_e2e_tasks.py runs the JAX package's CLI)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# after sr.main: nothing of JAX or of the JAX package was imported
_CLI = (
    'import sys\n'
    'from ucdir_tpu_torch import sr\n'
    'sr.main(sys.argv[1:])\n'
    'bad = sorted(k for k in sys.modules if k.split(".")[0] in\n'
    '             ("ucdir_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))\n'
    'assert not bad, bad\n')


def _write_images(d, n, size=48):
    g = np.random.default_rng(1)
    os.makedirs(d, exist_ok=True)
    names = []
    for i in range(n):
        names.append('%03d.png' % i)
        Image.fromarray(g.integers(0, 256, (size, size, 3), dtype=np.uint8)
                        ).save(os.path.join(d, names[-1]))
    return names


def _imagenet(tmp, n=3, size=48):
    """An Imagenet-style folder and its txt list."""
    names = _write_images(os.path.join(tmp, 'imgs'), n, size)
    txt = os.path.join(tmp, 'list.txt')
    with open(txt, 'w') as f:
        f.write('\n'.join(names))
    return {'root': os.path.join(tmp, 'imgs'), 'txt': txt}


def _narrow(task, tmp, **train):
    """The task's shipped config, narrowed: its model at inner 8, mults
    1-2, one res block, no attention; 2 train steps."""
    with open(os.path.join(ROOT, 'ucdir_tpu', 'configs', task + '.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['name'] = task + '-tiny'
    cfg['model']['unet'].update(inner_channel=8, channel_mults=[1, 2],
                                res_blocks=1, attn_res=[])
    cfg['train'].update(n_iter=2, **train)
    return cfg


def _cli(tmp, cfg, *args, env=None):
    path = os.path.join(tmp, 'tiny.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    proc = subprocess.run(
        [sys.executable, '-c', _CLI, '-c', path, '--device', 'cpu', *args],
        cwd=tmp, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2',
                 **(env or {})))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


def _found(tmp, suffix):
    return [f for _, _, fs in os.walk(os.path.join(tmp, 'experiments'))
            for f in fs if f.endswith(suffix)]


@pytest.mark.parametrize('task', ['gop-deblur', 'jpg-restore'])
def test_cli_val_of_the_task_on_cpu_loads_no_jax(tmp_path, task):
    """config.parse points validation at the task's test split (GoPro's
    input/target pairs; the Imagenet list, JPEG quality 10, the /16 crop)
    and sets 50 steps, which -debug caps to 10; PSNR and SSIM are printed
    and the results written."""
    tmp = str(tmp_path)
    cfg = _narrow(task, tmp)
    if task == 'gop-deblur':
        for sub in ('input', 'target'):
            _write_images(os.path.join(tmp, 'gtest', sub), 1)
        env = {'UCDIR_TPU_GOPRO_TEST_ROOT': os.path.join(tmp, 'gtest')}
    else:
        roots = _imagenet(tmp, n=1)
        env = {'UCDIR_TPU_IMAGENET_VAL_ROOT': roots['root'],
               'UCDIR_TPU_IMAGENET_VAL_TXT': roots['txt']}
    log = _cli(tmp, cfg, '-p', 'val', '-debug', env=env)
    assert log.count('val index') == 1
    run, = os.listdir(os.path.join(tmp, 'experiments'))
    assert run.endswith('_s50full' if task == 'gop-deblur'
                        else '_s50fullimage10')
    assert '# Validation # PSNR: ' in log and '# Validation # SSIM: ' in log
    assert _found(tmp, '_sr.jpg') == ['000_val_debug_%s-tiny-ema_sr.jpg'
                                      % task]


def test_cli_trains_jpg_restore_on_cpu_loads_no_jax(tmp_path):
    """Two steps on ImagenetJPGDataset items (a centre crop of 32, cv2 JPEG
    at a quality in [5, 30]), then a save."""
    tmp = str(tmp_path)
    cfg = _narrow('jpg-restore', tmp, print_freq=1, save_checkpoint_freq=2)
    roots = _imagenet(tmp, n=4)
    for phase in ('train', 'val'):
        cfg['datasets'][phase]['data_args']['dataroot'] = roots
    cfg['datasets']['train']['data_args']['crop_size'] = 32
    cfg['datasets']['train']['batch_size'] = 2
    log = _cli(tmp, cfg, '-p', 'train')
    assert log.count('l_pix: ') == 2
    assert 'End of training.' in log
    assert sorted(_found(tmp, '.pth')) == [
        'I_Elatest_gen.pth', 'I_Elatest_gen_ema.pth', 'I_Elatest_opt.pth']


def _realsr_cfg(tmp):
    """jpg-restore's config as DDPM_realsr on RealESRGANDataset items
    (crop 256: gt_size 256, 64 x 64 LQ), batch 1 and a queue of 1, the
    dopt1 preset."""
    cfg = _narrow('jpg-restore', tmp, print_freq=1)
    cfg['name'] = 'realsr-tiny'
    cfg['model']['name'] = 'DDPM_realsr'
    cfg.update(dopt='dopt1', queue_size=1, gt_usm=False)
    roots = _imagenet(tmp, n=4, size=64)
    for phase in ('train', 'val'):
        cfg['datasets'][phase]['datasetname'] = 'RealESRGANDataset'
        cfg['datasets'][phase]['data_args'] = {'dataroot': roots,
                                               'crop_size': 256}
    cfg['datasets']['train']['batch_size'] = 1
    return cfg


def test_cli_trains_realsr_on_cpu_loads_no_jax(tmp_path):
    """Two DDPM_realsr steps: each fed batch degraded by the two-stage feed
    on the trainer's device, the pairs through the queue (the first fills
    it, the second swaps)."""
    log = _cli(str(tmp_path), _realsr_cfg(str(tmp_path)), '-p', 'train')
    assert log.count('l_pix: ') == 2
    assert 'End of training.' in log


def test_realsr_options_reach_the_trainer(tmp_path):
    """The config's top-level dopt, queue_size and gt_usm reach
    TrainerRealSR through config.parse and create_model, as in the JAX
    package."""
    from ucdir_tpu_torch import config, realsr
    from ucdir_tpu_torch.trainer import create_model
    path = str(tmp_path / 'realsr.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(_realsr_cfg(str(tmp_path)), f)
    opt = config.parse(path, phase='train', make_dirs=False)
    trainer = create_model(opt, device='cpu')
    assert type(trainer) is realsr.TrainerRealSR
    assert trainer.dopt is realsr.DOPTS['dopt1']
    assert (trainer.queue_size, trainer.gt_usm_for_hr) == (1, False)
    del opt['dopt']
    opt['queue_size'], opt['gt_usm'] = None, None
    trainer = create_model(opt, device='cpu')
    assert trainer.dopt is realsr.dopt
    assert (trainer.queue_size, trainer.gt_usm_for_hr) == (180, True)
