"""The optimizer step. Counterpart of `make_train_step` in
`ucdir_tpu/train/step.py` (reference: model/model.py:104-122): draw the noise
level and the noise, `p_losses / (b * c * h * w)`, backward, clip, optimizer
update, EMA blend; in float32, or in bfloat16 on float32 master weights
(`compute_dtype`). `ucdir_tpu_torch/eval.py` holds the evaluation half."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ucdir_tpu_torch.diffusion.sampler import sample_continuous_gamma
from ucdir_tpu_torch.schedule import NoiseSchedule
from ucdir_tpu_torch.train.state import TrainState


def step_loss(model, sched: NoiseSchedule, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None,
              compute_dtype: Optional[torch.dtype] = None):
    """The loss of one step, `p_losses / (b * c * h * w)`, on batch {'HR',
    'SR'} (B, H, W, C) tensors on the model's device. The noise level, the
    noise and (in train() mode) the dropout mask come from `generator`, in
    this order; `draws` may inject 'gammas' (B, 1) and 'noise' (like HR).

    compute_dtype (e.g. torch.bfloat16): mixed precision, as the JAX
    package's `make_train_step(compute_dtype=)`. The float32 parameters stay
    the model's (and the optimizer's); the networks run on their cast to
    `compute_dtype`, a differentiable copy made anew at every call and handed
    to `torch.func.functional_call`, so that each parameter's gradient is
    the compute-dtype cotangent widened to float32. The batch, the gammas and
    the noise (drawn in float32) are cast too; the loss is summed and divided
    in float32."""
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
    if compute_dtype is None:
        loss = model.p_losses(batch, gammas, noise,
                              dropout_generator=generator)
    else:
        params = {n: p.to(compute_dtype)
                  for n, p in model.named_parameters()}
        loss = torch.func.functional_call(
            model, params,
            ({k: v.to(compute_dtype) for k, v in batch.items()},
             gammas.to(compute_dtype), noise.to(compute_dtype)),
            {'dropout_generator': generator})
    return loss.float() / (b * c * h * w)


def train_step(state: TrainState, sched: NoiseSchedule,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               compute_dtype: Optional[torch.dtype] = None):
    """One optimizer step: `step_loss` (in `compute_dtype`, None: float32),
    backward, clip, update, EMA blend, all on the float32 parameters.
    Updates `state` in place and returns the loss as a 0-dim tensor."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = step_loss(state.model, sched, batch, generator, draws,
                     compute_dtype)
    loss.backward()
    if state.clip_norm is not None:
        torch.nn.utils.clip_grad_norm_(
            [p for p in state.model.parameters() if p.grad is not None],
            state.clip_norm)
    state.optimizer.step()
    state.update_ema()
    state.step += 1
    return loss.detach()
