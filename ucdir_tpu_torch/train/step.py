"""The optimizer step. Counterpart of `make_train_step` in
`ucdir_tpu/train/step.py` (reference: model/model.py:104-122): draw the noise
level and the noise, `p_losses / (b * c * h * w)`, backward, clip, optimizer
update, EMA blend; in float32, or in bfloat16 on float32 master weights
(`compute_dtype`). `ucdir_tpu_torch/eval.py` holds the evaluation half.

Data parallel (`world_size` > 1, `make_train_step(mesh=)`'s counterpart):
each rank holds its rows of the global batch, draws the global batch's noise
levels, noise and dropout mask from the step's generator, the same on every
rank, and keeps its rows, so the loss is a function of the global batch
alone. The gradients and the loss are then averaged over the ranks in one
all-reduce before clipping; the mean of the ranks' losses, each divided by
its own b * c * h * w, is the global batch's loss. One rank is the
one-process step, bit for bit: no all-reduce is issued."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ucdir_tpu_torch.diffusion.sampler import sample_continuous_gamma
from ucdir_tpu_torch.parallel.mesh import (DataShard, all_reduce_mean_,
                                           data_shard)
from ucdir_tpu_torch.schedule import NoiseSchedule
from ucdir_tpu_torch.train.state import TrainState


def step_loss(model, sched: NoiseSchedule, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None,
              compute_dtype: Optional[torch.dtype] = None,
              rank: int = 0, world_size: int = 1):
    """The loss of one step, `p_losses / (b * c * h * w)`, on batch {'HR',
    'SR'} (B, H, W, C) tensors on the model's device: rank `rank`'s rows of
    a global batch of `world_size` * B. The noise level, the noise and (in
    train() mode) the dropout mask come from `generator`, in this order,
    drawn at the global batch, of which the rank keeps its rows; `draws` may
    inject the global batch's 'gammas' (world_size * B, 1) and 'noise'
    (world_size * B, H, W, C), of which it keeps its rows too. A model in
    `sample_mode` 'refine' (NoDiffusion) takes the constant
    sqrt_alphas_cumprod_prev[1] as its gammas, drawn or injected ones
    ignored.

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
    if getattr(model, 'sample_mode', 'reverse') == 'refine':
        # NoDiffusion trains at the constant sqrt_alphas_cumprod_prev[1]
        # (reference diffusion.py:638-644): nothing is drawn for it
        gammas = sched.sqrt_alphas_cumprod_prev[1].expand(
            b * world_size, 1).to(hr.dtype)
    elif gammas is None:
        gammas = sample_continuous_gamma(sched, b * world_size, generator)
    noise = draws.get('noise')
    if noise is None:
        noise = torch.randn((b * world_size, h, w, c), device=hr.device,
                            dtype=hr.dtype, generator=generator)
    if world_size > 1:
        gammas = data_shard(gammas, rank, world_size)
        noise = data_shard(noise, rank, world_size)
        if generator is not None:
            generator = DataShard(generator, rank, world_size)
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
               compute_dtype: Optional[torch.dtype] = None,
               rank: int = 0, world_size: int = 1):
    """One optimizer step: `step_loss` (in `compute_dtype`, None: float32),
    backward, with `world_size` > 1 the gradients and the loss averaged over
    the ranks, clip, update, EMA blend, all on the float32 parameters.
    Updates `state` in place and returns the loss (the global batch's) as a
    0-dim tensor."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = step_loss(state.model, sched, batch, generator, draws,
                     compute_dtype, rank, world_size)
    loss.backward()
    loss = loss.detach()
    if world_size > 1:
        all_reduce_mean_([p.grad for p in state.model.parameters()
                          if p.grad is not None] + [loss])
    if state.clip_norm is not None:
        torch.nn.utils.clip_grad_norm_(
            [p for p in state.model.parameters() if p.grad is not None],
            state.clip_norm)
    state.optimizer.step()
    state.update_ema()
    state.step += 1
    return loss
