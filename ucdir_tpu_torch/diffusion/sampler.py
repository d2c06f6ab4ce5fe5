"""The samplers as Python loops. Counterpart of
`ucdir_tpu/diffusion/sampler.py` (reference: model/diffusion.py:160-294,
473-478).

  * `p_sample_loop`: the ancestral DDPM reverse loop.
  * `ddim_sample`: DDIM(eta) over `sampling_timesteps` steps.
  * `super_resolution`: predictor, guided reverse loop (whole image or
    tiled), + initx; dispatches on `sampler` (the DPM-Solver++ forms live in
    `diffusion/dpm_solver.py`).
  * `sample_continuous_gamma`: the training-time noise level.

Noise is injectable: `noise(shape)` is called once for the initial draw and
then once per step (DDPM: t = T-1 down to 0, the t = 0 draw multiplied by 0,
as in the JAX scan; DDIM: every step, the last one's unused). The default
draws from a `torch.Generator`.

Mixed precision (`compute_dtype`, as the JAX package's): the networks run on
a copy of the weights in that dtype, made once per call, on the input, the
guide and each step's image and noise level in that dtype; initx and every
eps come back as float32, and the sampler state, the draws and the posterior
math stay float32.
"""
from __future__ import annotations

import copy
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


def ddim_sample(denoise: Callable, x_cond: torch.Tensor,
                sched: NoiseSchedule, noise: Noise,
                sampling_timesteps: int = 5, eta: float = 1.0,
                clip_x_start: bool = True, continous: bool = False):
    """DDIM(eta) reverse loop (reference diffusion.py:247-294) over the pairs
    of `linspace(-1, T - 1, sampling_timesteps + 1)` truncated to integers,
    from T - 1 down; the step to t_next = -1 returns the clipped x0. Returns
    the final image, or (final, snapshots) when continous: the initial noise,
    then every step's image."""
    shape = tuple(x_cond.shape)
    T = sched.num_timesteps
    times = np.linspace(-1, T - 1, sampling_timesteps + 1).astype(np.int64)
    times = list(reversed(times.tolist()))
    img = noise(shape)
    snaps = [img]
    for t, t_next in zip(times[:-1], times[1:]):
        noise_level = sched.sqrt_alphas_cumprod_prev[t + 1].expand(
            shape[0], 1)
        eps = denoise(img, noise_level)
        x0 = (sched.sqrt_recip_alphas_cumprod[t] * img
              - sched.sqrt_recipm1_alphas_cumprod[t] * eps)
        if clip_x_start:
            x0 = x0.clamp(-1., 1.)
        z = noise(shape)
        if t_next < 0:
            img = x0
        else:
            alpha = sched.alphas_cumprod[t]
            alpha_next = sched.alphas_cumprod[t_next]
            sigma = eta * torch.sqrt((1 - alpha / alpha_next)
                                     * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt((1 - alpha_next - sigma ** 2).clamp(min=0.))
            img = x0 * torch.sqrt(alpha_next) + c * eps + sigma * z
        if continous:
            snaps.append(img)
    if continous:
        return img, torch.stack(snaps, dim=0)
    return img


# Largest input (after the validation pad) restored as one image when no tile
# options are given; larger ones take the tiled path. 1424 x 2128 SID frames
# pad to 1552 x 2256, about 3.5 M px.
UNTILED_MAX_PX = 4_300_000


def cast_model(model: torch.nn.Module, dtype: torch.dtype):
    """A copy of `model` with every parameter in `dtype`; `model` keeps its
    weights. The copy starts without the kernel-layout weights that `model`
    caches (models/layers.py `cached`): it builds its own."""
    memo = {id(m.__dict__['_kernel_layout']): {} for m in model.modules()
            if '_kernel_layout' in m.__dict__}
    return copy.deepcopy(model, memo).to(dtype)


@torch.no_grad()
def super_resolution(model, sched: NoiseSchedule, x_in: torch.Tensor,
                     noise: Optional[Noise] = None,
                     generator: Optional[torch.Generator] = None,
                     continous: bool = False, sampler: str = 'ddpm',
                     sampling_timesteps: int = 5, eta: float = 1.0,
                     tile_opts: Optional[dict] = None,
                     compute_dtype: Optional[torch.dtype] = None):
    """Restoration for ResiGaussianGuideDY: initx = predictor(x_in); the
    reverse loop conditioned on x_in with initx guiding AKGM (its guide maps
    computed once); result + initx. Returns (sr, initx) or (sr, initx,
    snapshots). Give `noise` or a `generator` for the draws.

    sampler: 'ddpm' | 'ddim' | 'dpmpp' | 'dpmpp_sde'; the last three take
    `sampling_timesteps` steps, ddim also `eta`. tile_opts: {skip, padding,
    tile_chunk} runs every denoiser call tiled (parallel/tiled.py); None
    tiles, with the defaults, only inputs above UNTILED_MAX_PX.
    compute_dtype: e.g. torch.bfloat16 runs the networks in that dtype (the
    module docstring); the results stay float32."""
    if noise is None:
        if generator is None:
            raise ValueError('super_resolution needs noise= or generator=')
        noise = generator_noise(generator)
    net, x_net = model, x_in
    if compute_dtype is not None:
        net, x_net = cast_model(model, compute_dtype), x_in.to(compute_dtype)
    dt = x_net.dtype
    initx = net.predict_init(x_net).to(x_in.dtype)
    guide = {'initx': initx, 'degraded': x_in}[model.guide_in_sample]
    guide_net = guide.to(dt)

    h, w = x_in.shape[1], x_in.shape[2]
    if tile_opts is None and h * w > UNTILED_MAX_PX:
        tile_opts = {}
    if tile_opts is not None:
        from ucdir_tpu_torch.parallel.tiled import tiled_denoise_fn
        tiled = tiled_denoise_fn(
            net.denoise_fn, x_net, guide_net,
            skip=tile_opts.get('skip', 1024),
            padding=tile_opts.get('padding', 64),
            tile_chunk=tile_opts.get('tile_chunk', 1))

        def denoise(img, noise_level):
            return tiled(img.to(dt), noise_level.to(dt)).to(img.dtype)
    else:
        gmaps = compute_guide_maps(net.denoise_fn,
                                   pad_to_multiple(guide_net, 32)[0])

        def denoise(img, noise_level):
            return net.denoise(torch.cat([x_net, img.to(dt)], dim=-1),
                               noise_level.to(dt), guide_net,
                               guide_maps=gmaps).to(img.dtype)

    if sampler == 'ddpm':
        out = p_sample_loop(denoise, x_in, sched, noise, continous=continous)
    elif sampler == 'ddim':
        out = ddim_sample(denoise, x_in, sched, noise,
                          sampling_timesteps=sampling_timesteps, eta=eta,
                          continous=continous)
    elif sampler in ('dpmpp', 'dpmpp_sde'):
        from ucdir_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_sample
        out = dpm_solver_pp_sample(denoise, x_in, sched, noise,
                                   steps=sampling_timesteps,
                                   continous=continous,
                                   sde=(sampler == 'dpmpp_sde'))
    else:
        raise NotImplementedError(sampler)
    if continous:
        img, snaps = out
        return img + initx, initx, snaps + initx[None]
    return out + initx, initx
