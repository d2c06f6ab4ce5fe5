"""Optimizer factory: adamw / adam / lion. Counterpart of
`ucdir_tpu/train/optim.py` (reference: model/model.py:78-89 and the
hand-written Lion of utils/util.py:7-68). Hyperparameters are the torch
defaults the reference relies on:
  * AdamW: betas (0.9, 0.999), eps 1e-8, weight_decay 0.01;
  * Adam: the same, weight_decay 0;
  * Lion: betas (0.9, 0.99), weight_decay 0.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn


class Lion(torch.optim.Optimizer):
    """update = sign(b1 * m + (1 - b1) * g); p -= lr * (update + wd * p);
    m = b2 * m + (1 - b2) * g. PyTorch ships no Lion."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, (b1, b2) = group['lr'], group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['exp_avg'] = torch.zeros_like(p)
                m = state['exp_avg']
                update = torch.sign(m * b1 + p.grad * (1 - b1))
                if group['weight_decay']:
                    update = update + group['weight_decay'] * p
                p.add_(update, alpha=-lr)
                m.mul_(b2).add_(p.grad, alpha=1 - b2)


def finetune_select(model: nn.Module, substring: str = 'transformer'):
    """The reference's finetune_norm (model/model.py:62-77): freeze every
    parameter, then zero and optimize only those whose name contains
    `substring`. Returns the parameters to optimize."""
    chosen = []
    for name, p in model.named_parameters():
        hit = substring in name
        p.requires_grad_(hit)
        if hit:
            with torch.no_grad():
                p.zero_()
            chosen.append(p)
    if not chosen:
        raise ValueError("finetune_norm: no parameter name contains '%s'"
                         % substring)
    return chosen


def make_optimizer(params, optimizer_opt: Dict[str, Any]):
    """A torch optimizer over `params` from a config's train.optimizer
    section ({type, lr})."""
    kind = optimizer_opt.get('type', 'adamw')
    lr = float(optimizer_opt.get('lr', 1e-4))
    params = list(params)
    if kind == 'adamw':
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)
    if kind == 'adam':
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if kind == 'lion':
        return Lion(params, lr=lr, betas=(0.9, 0.99), weight_decay=0.0)
    raise NotImplementedError(kind)
