"""The optimizer step. Counterpart of `make_train_step` in
`ucdir_tpu/train/step.py` (reference: model/model.py:104-122): draw the noise
level and the noise, `p_losses / (b * c * h * w)`, backward, clip, optimizer
update, EMA blend. `ucdir_tpu_torch/eval.py` holds the evaluation half."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ucdir_tpu_torch.diffusion.sampler import sample_continuous_gamma
from ucdir_tpu_torch.schedule import NoiseSchedule
from ucdir_tpu_torch.train.state import TrainState


def step_loss(model, sched: NoiseSchedule, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None):
    """The loss of one step, `p_losses / (b * c * h * w)`, on batch {'HR',
    'SR'} (B, H, W, C) tensors on the model's device. The noise level, the
    noise and (in train() mode) the dropout mask come from `generator`, in
    this order; `draws` may inject 'gammas' (B, 1) and 'noise' (like HR)."""
    draws = draws or {}
    hr = batch['HR']
    b, h, w, c = hr.shape
    gammas = draws.get('gammas')
    if gammas is None:
        gammas = sample_continuous_gamma(sched, b, generator)
    noise = draws.get('noise')
    if noise is None:
        noise = torch.randn(hr.shape, device=hr.device, dtype=hr.dtype,
                            generator=generator)
    return model.p_losses(batch, gammas, noise,
                          dropout_generator=generator) / (b * c * h * w)


def train_step(state: TrainState, sched: NoiseSchedule,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None):
    """One optimizer step: `step_loss`, backward, clip, update, EMA blend.
    Updates `state` in place and returns the loss as a 0-dim tensor."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = step_loss(state.model, sched, batch, generator, draws)
    loss.backward()
    if state.clip_norm is not None:
        torch.nn.utils.clip_grad_norm_(
            [p for p in state.model.parameters() if p.grad is not None],
            state.clip_norm)
    state.optimizer.step()
    state.update_ema()
    state.step += 1
    return loss.detach()
