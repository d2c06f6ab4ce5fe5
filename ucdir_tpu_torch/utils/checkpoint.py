"""Checkpoints as the reference's triple (model/model.py:193-267):

    I{iter}_E{epoch}_gen.pth      the live weights' state dict
    I{iter}_E{epoch}_gen_ema.pth  the EMA shadow, same names
    I{iter}_E{epoch}_opt.pth      {'epoch', 'iter', 'scheduler': None,
                                   'optimizer': state dict, 'step': int}

Counterpart of `ucdir_tpu/utils/checkpoint.py`, which keeps one orbax
directory per tag instead. 'step' is this port's addition: the reference
reads the step back from 'iter', which is '' in its `I_Elatest` files.
"""
from __future__ import annotations

import os

import torch

from ucdir_tpu_torch.train.state import TrainState


def save_state(ckpt_dir: str, epoch, iter_step, state: TrainState) -> str:
    """Writes the triple under ckpt_dir; returns its prefix."""
    os.makedirs(ckpt_dir, exist_ok=True)
    prefix = os.path.join(ckpt_dir, 'I{}_E{}'.format(iter_step, epoch))
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}
    torch.save(cpu(state.model.state_dict()), prefix + '_gen.pth')
    torch.save(cpu(state.ema_params), prefix + '_gen_ema.pth')
    torch.save({'epoch': epoch, 'iter': iter_step, 'scheduler': None,
                'optimizer': state.optimizer.state_dict(),
                'step': state.step}, prefix + '_opt.pth')
    return prefix


def restore_state(prefix: str, state: TrainState):
    """Loads the triple at `prefix` into `state` (strict names). Returns
    (step, epoch): the step from 'step' or an integer 'iter', the epoch 0
    where the file names none (`I_Elatest`)."""
    dev = next(state.model.parameters()).device
    load = lambda suffix: torch.load(prefix + suffix, map_location=dev,
                                     weights_only=True)
    for suffix in ('_gen.pth', '_gen_ema.pth', '_opt.pth'):
        if not os.path.isfile(prefix + suffix):
            raise FileNotFoundError('checkpoint not found: %s'
                                    % (prefix + suffix))
    state.model.load_state_dict(load('_gen.pth'), strict=True)
    ema = load('_gen_ema.pth')
    if ema.keys() != state.ema_params.keys():
        raise KeyError('EMA checkpoint names differ from the model: %s'
                       % sorted(ema.keys() ^ state.ema_params.keys())[:5])
    for k, v in ema.items():
        state.ema_params[k].copy_(v)
    opt = load('_opt.pth')
    state.optimizer.load_state_dict(opt['optimizer'])
    step = opt.get('step')
    if step is None:
        step = int(opt['iter'])
    state.step = int(step)
    epoch = opt['epoch'] if isinstance(opt['epoch'], int) else 0
    return state.step, epoch
