"""The ancestral DDPM sampler as a Python loop. Counterpart of
`ucdir_tpu/diffusion/sampler.py` (reference: model/diffusion.py:160-211,
473-478).

`sample_continuous_gamma` draws the training-time noise level.

Noise is injectable: `noise(shape)` is called once for the initial draw and
then once per step, t = T-1 down to 0 (the t = 0 draw is multiplied by 0, as
in the JAX scan). The default draws from a `torch.Generator`.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ucdir_tpu_torch.models.dy3h import compute_guide_maps
from ucdir_tpu_torch.models.layers import pad_to_multiple
from ucdir_tpu_torch.schedule import NoiseSchedule

Noise = Callable[[tuple], torch.Tensor]


def generator_noise(generator: torch.Generator) -> Noise:
    """Standard normal draws from `generator`, on the generator's device."""
    def draw(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
    return draw


def sample_continuous_gamma(sched: NoiseSchedule, batch: int,
                            generator: Optional[torch.Generator] = None,
                            t: Optional[int] = None, u=None):
    """The training-time noise level (reference diffusion.py:315-331): one t
    per batch in [1, T], then per-sample gamma uniform between
    sqrt_alphas_cumprod_prev[t - 1] and [t]. Returns (batch, 1) on the
    schedule's device. The draws come from `generator`, or are injected: `t`
    an int, `u` (batch, 1) uniforms in [0, 1)."""
    dev = sched.betas.device
    if t is None:
        t = int(torch.randint(1, sched.num_timesteps + 1, (), device=dev,
                              generator=generator))
    if u is None:
        u = torch.rand(batch, 1, device=dev, dtype=sched.betas.dtype,
                       generator=generator)
    lo = sched.sqrt_alphas_cumprod_prev[t - 1]
    hi = sched.sqrt_alphas_cumprod_prev[t]
    return lo + torch.as_tensor(u, device=dev) * (hi - lo)


def _snapshot_slots(T: int):
    """Per-step snapshot slot for the reference's cadence: a snapshot every
    `1 | (T // 10)` steps, i counting down from T-1. Every step writes its
    image into slot = the number of snapshot steps before it, so each slot's
    last writer is a snapshot step. Returns (slots, number of slots)."""
    sample_inter = 1 | (T // 10)
    slots, n = [], 0
    for t in range(T - 1, -1, -1):
        slots.append(n)
        if t % sample_inter == 0:
            n += 1
    return np.asarray(slots, np.int32), n


def p_sample_loop(denoise: Callable, x_cond: torch.Tensor,
                  sched: NoiseSchedule, noise: Noise,
                  continous: bool = False, clip_denoised: bool = True):
    """Ancestral reverse loop. denoise(img, noise_level (B, 1)) -> eps.
    Returns the final image, or (final, snapshots) when continous: snapshot
    0 is x_cond, then one every `1 | (T // 10)` steps."""
    shape = tuple(x_cond.shape)
    T = sched.num_timesteps
    img = noise(shape)
    slots, n_snap = _snapshot_slots(T)
    buf = x_cond.new_zeros((n_snap,) + shape) if continous else None
    for i, t in enumerate(range(T - 1, -1, -1)):
        noise_level = sched.sqrt_alphas_cumprod_prev[t + 1].expand(
            shape[0], 1)
        eps = denoise(img, noise_level)
        x0 = (sched.sqrt_recip_alphas_cumprod[t] * img
              - sched.sqrt_recipm1_alphas_cumprod[t] * eps)
        if clip_denoised:
            x0 = x0.clamp(-1., 1.)
        mean = (sched.posterior_mean_coef1[t] * x0
                + sched.posterior_mean_coef2[t] * img)
        z = noise(shape)
        if t == 0:
            z = torch.zeros_like(z)
        logvar = sched.posterior_log_variance_clipped[t]
        img = mean + z * torch.exp(0.5 * logvar)
        if buf is not None:
            buf[int(slots[i])] = img
    if continous:
        return img, torch.cat([x_cond[None], buf], dim=0)
    return img


@torch.no_grad()
def super_resolution(model, sched: NoiseSchedule, x_in: torch.Tensor,
                     noise: Optional[Noise] = None,
                     generator: Optional[torch.Generator] = None,
                     continous: bool = False):
    """Restoration for ResiGaussianGuideDY: initx = predictor(x_in); the
    reverse loop conditioned on x_in with initx guiding AKGM (its guide maps
    computed once); result + initx. Returns (sr, initx) or (sr, initx,
    snapshots). Give `noise` or a `generator` for the draws."""
    if noise is None:
        if generator is None:
            raise ValueError('super_resolution needs noise= or generator=')
        noise = generator_noise(generator)
    initx = model.predict_init(x_in)
    guide = {'initx': initx, 'degraded': x_in}[model.guide_in_sample]
    gmaps = compute_guide_maps(model.denoise_fn, pad_to_multiple(guide, 32)[0])

    def denoise(img, noise_level):
        return model.denoise(torch.cat([x_in, img], dim=-1), noise_level,
                             guide, guide_maps=gmaps)

    out = p_sample_loop(denoise, x_in, sched, noise, continous=continous)
    if continous:
        img, snaps = out
        return img + initx, initx, snaps + initx[None]
    return out + initx, initx
