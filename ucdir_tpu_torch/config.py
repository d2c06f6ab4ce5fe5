"""Config system: YAML load + phase-dependent mutation. Counterpart of
`ucdir_tpu/config.py` (the port keeps its own copy; the process count is an
argument here and never read from a framework).

Behavioral parity with core/logger.py:22-230 (`parse`,
`NoneDict`, `dict_to_nonedict`, `dict2str`):
  * val phase renames the run `val_<name>`, overrides the resume checkpoint,
    forces `data_len=-1` / `split='val'`;
  * per-task val overrides: names containing 'sid' and 'gop-' get the 50-step
    linear_end=0.4 sampling schedule; 'jpg-' additionally pins the JPEG quality
    factor to [10, 10] and crop_size=-1 (core/logger.py:58-136);
  * `-ema` suffix when the EMA scheduler is enabled;
  * timestamped experiments/ directory tree;
  * per-process batch-size division by `num_processes`
    (core/logger.py:162-168);
  * `-debug` shrinks freqs/batch/steps/data_len (core/logger.py:171-179).

Implemented over PyYAML (omegaconf is not available in this image).
"""
from __future__ import annotations

import os
from datetime import datetime
from typing import Any, Optional

import yaml


class NoneDict(dict):
    """dict returning None for missing keys (reference: core/logger.py:202-204)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def dict2str(opt, indent_l: int = 1) -> str:
    msg = ''
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += ' ' * (indent_l * 2) + k + ':[\n'
            msg += dict2str(v, indent_l + 1)
            msg += ' ' * (indent_l * 2) + ']\n'
        else:
            msg += ' ' * (indent_l * 2) + k + ': ' + str(v) + '\n'
    return msg


def get_timestamp() -> str:
    return datetime.now().strftime('%y%m%d_%H%M%S')


def mkdirs(paths):
    if isinstance(paths, str):
        os.makedirs(paths, exist_ok=True)
    else:
        for p in paths:
            os.makedirs(p, exist_ok=True)


def load_yaml(path: str) -> dict:
    with open(path, 'r') as f:
        return yaml.safe_load(f)


def parse(config: str,
          phase: str = 'train',
          checkpoint: Optional[str] = None,
          debug: bool = False,
          enable_wandb: bool = False,
          num_processes: int = 1,
          make_dirs: bool = True) -> NoneDict:
    """Load + mutate a run config. Mirrors core/logger.py:parse.

    Args:
      config: path to a YAML file following the configs/sid.yaml schema.
      phase: 'train' or 'val'.
      checkpoint: resume/eval checkpoint prefix (reference `--checkpoint`).
      num_processes: world size for per-process batch division.
      make_dirs: create the experiments/ tree (disable in tests).
    """
    opt = load_yaml(config)

    if debug:
        opt['name'] = 'debug_{}'.format(opt['name'])
    if phase == 'val':
        opt['name'] = 'val_{}'.format(opt['name'])

    fix = ''
    if phase == 'val':
        opt['path']['resume_state'] = checkpoint
        opt['datasets']['val']['data_args']['data_len'] = -1
        if 'sr-' in opt['name']:
            opt['datasets']['val']['data_args']['data_len'] = 5000
        opt['datasets']['val']['data_args']['split'] = 'val'

        # per-task evaluation overrides (core/logger.py:58-136)
        if 'sid' in opt['name']:
            opt['model']['beta_schedule']['val']['n_timestep'] = 50
            opt['model']['beta_schedule']['val']['linear_end'] = 4e-1
        elif 'gop-' in opt['name']:
            # point val at the full GoPro test split (core/logger.py:63-112
            # hardcodes the cluster path; here the root is configurable)
            gop_root = os.environ.get('UCDIR_TPU_GOPRO_TEST_ROOT',
                                      './dataset/GoPro/test')
            opt['datasets']['val']['data_args']['dataroot'] = {
                'lq': os.path.join(gop_root, 'input'),
                'gt': os.path.join(gop_root, 'target')}
            fix += 'full'
            opt['model']['beta_schedule']['val']['n_timestep'] = 50
            opt['model']['beta_schedule']['val']['linear_end'] = 4e-1
        elif 'jpg-' in opt['name']:
            # point val at the imagenet val list (core/logger.py:113-136)
            opt['datasets']['val']['data_args']['dataroot'] = {
                'root': os.environ.get('UCDIR_TPU_IMAGENET_VAL_ROOT',
                                       './dataset/imagenet/val'),
                'txt': os.environ.get('UCDIR_TPU_IMAGENET_VAL_TXT',
                                      './imagenet_val_1k.txt')}
            opt['datasets']['val']['data_args']['factor'] = [10, 10]
            fix += 'fullimage10'
            opt['datasets']['val']['data_args']['crop_size'] = -1
            opt['model']['beta_schedule']['val']['n_timestep'] = 50
            opt['model']['beta_schedule']['val']['linear_end'] = 4e-1
        else:
            raise ValueError('val name not supported: %s' % opt['name'])

        if opt['train']['ema_scheduler']['use']:
            opt['name'] += '-ema'

    experiments_root = os.path.join(
        'experiments', '{}_{}'.format(get_timestamp(), opt['name']))
    if phase == 'val':
        experiments_root += '_s{}'.format(opt['model']['beta_schedule']['val']['n_timestep'])
        experiments_root += fix

    opt['path']['experiments_root'] = experiments_root
    for key, path in list(opt['path'].items()):
        if 'resume' not in key and 'experiments' not in key and path is not None:
            opt['path'][key] = os.path.join(experiments_root, path)
            if make_dirs:
                mkdirs(opt['path'][key])

    opt['phase'] = phase
    opt['distributed'] = True

    temp_bs = opt['datasets']['train']['batch_size']
    if phase == 'train':
        assert temp_bs % num_processes == 0, (temp_bs, num_processes)
    opt['datasets']['train']['batch_size'] = temp_bs // num_processes

    if 'debug' in opt['name']:
        opt['train']['val_freq'] = 2
        opt['train']['print_freq'] = 2
        opt['train']['save_checkpoint_freq'] = 3
        opt['datasets']['train']['batch_size'] = 2
        opt['model']['beta_schedule']['train']['n_timestep'] = 10
        opt['model']['beta_schedule']['val']['n_timestep'] = 10
        opt['datasets']['train']['data_len'] = 6
        opt['datasets']['val']['data_len'] = 3

    opt['enable_wandb'] = enable_wandb
    return dict_to_nonedict(opt)
