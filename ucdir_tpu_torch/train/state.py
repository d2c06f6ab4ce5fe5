"""TrainState: the model, its optimizer, the EMA shadow and the step count.
Counterpart of `ucdir_tpu/train/state.py`.

EMA semantics (reference model/model.py:19-32, 118-121):
  * the shadow starts as a copy of the initial weights;
  * blending (decay 0.9999) happens only when the pre-increment step is
    > step_start_ema (5000) and divisible by update_ema_every;
  * evaluation loads the EMA weights (model.py:236-239).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Dict[str, torch.Tensor]    # by state-dict name
    step: int = 0
    use_ema: bool = True
    decay: float = 0.9999
    step_start_ema: int = 5000
    update_ema_every: int = 1
    clip_norm: Optional[float] = None

    @torch.no_grad()
    def update_ema(self):
        """Blends the live weights into the shadow if the gate is open at the
        current (pre-increment) step; returns whether it did."""
        if not (self.use_ema and self.step > self.step_start_ema
                and self.step % self.update_ema_every == 0):
            return False
        live = self.model.state_dict()
        names = list(self.ema_params)
        torch._foreach_lerp_([self.ema_params[k] for k in names],
                             [live[k] for k in names], 1. - self.decay)
        return True


def create_train_state(model: nn.Module, optimizer,
                       ema_opt: Optional[Dict[str, Any]] = None,
                       clip_norm: Optional[float] = None) -> TrainState:
    ema_opt = ema_opt or {}
    return TrainState(
        model=model, optimizer=optimizer,
        ema_params={k: v.detach().clone()
                    for k, v in model.state_dict().items()},
        use_ema=bool(ema_opt.get('use', True)),
        decay=float(ema_opt.get('ema_decay', 0.9999)),
        step_start_ema=int(ema_opt.get('step_start_ema', 5000)),
        update_ema_every=int(ema_opt.get('update_ema_every', 1)),
        clip_norm=None if clip_norm is None else float(clip_norm))
