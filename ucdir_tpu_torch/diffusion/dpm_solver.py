"""DPM-Solver++(2M) and SDE-DPM-Solver++(2M) as a Python loop. Counterpart of
`ucdir_tpu/diffusion/dpm_solver.py` (reference: the `dpm_solver` alternative
loop of sr.py:185-241, which wraps Lu et al.'s solver: discrete schedule,
data prediction, multistep order 2, time_uniform).

  alpha_t = sqrt(abar_t), sigma_t = sqrt(1 - abar_t), lambda = log(alpha/sigma)
  x0_i    = (x - sigma_i * eps(x, t_i)) / alpha_i
  D_i     = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}        (r_i = h_{i-1}/h_i)
  x_{i+1} = (sigma_{i+1}/sigma_i) x_i - alpha_{i+1} (e^{-h_i} - 1) D_i

with a first-order step on the first iteration (no history) and on the last
(the solver's lower_order_final). The denoiser sees the continuous noise
level sqrt_alphas_cumprod_prev[t + 1], as in the other samplers.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ucdir_tpu_torch.schedule import NoiseSchedule


def dpm_solver_pp_sample(denoise: Callable, x_cond: torch.Tensor,
                         sched: NoiseSchedule, noise: Callable,
                         steps: int = 20, clip_denoised: bool = True,
                         continous: bool = False, sde: bool = False):
    """denoise(img, noise_level (B, 1)) -> eps. Timesteps are
    `linspace(T - 1, 0, steps + 1)` rounded. sde=True injects fresh noise
    every step (zeroed on the step that lands on t = 0), which keeps the
    denoiser's error from accumulating along the deterministic trajectory.

    `noise(shape)` is called once for the initial image and, with sde, once
    per step. Returns the final image, or (final, snapshots) when continous:
    every step's image, without the initial noise."""
    shape = tuple(x_cond.shape)
    T = sched.num_timesteps
    ts = np.linspace(T - 1, 0, steps + 1).round().astype(np.int32).tolist()

    alphas = torch.sqrt(sched.alphas_cumprod)
    sigmas = torch.sqrt(1. - sched.alphas_cumprod)
    lambdas = torch.log(alphas) - torch.log(sigmas)

    img = noise(shape)
    x0_prev = torch.zeros_like(img)
    h_prev = torch.zeros((), dtype=img.dtype, device=img.device)
    snaps = []
    for i, (t, t_next) in enumerate(zip(ts[:-1], ts[1:])):
        noise_level = sched.sqrt_alphas_cumprod_prev[t + 1].expand(
            shape[0], 1)
        x0 = (img - sigmas[t] * denoise(img, noise_level)) / alphas[t]
        if clip_denoised:
            x0 = x0.clamp(-1., 1.)
        h = lambdas[t_next] - lambdas[t]
        r = torch.where(h_prev != 0, h_prev / h, torch.ones_like(h))
        second = 0 < i < steps - 1
        if sde:
            em2h = -torch.expm1(-2. * h)            # 1 - e^{-2h}
            z = noise(shape)
            if t_next == 0:
                z = torch.zeros_like(z)
            new = ((sigmas[t_next] / sigmas[t]) * torch.exp(-h) * img
                   + alphas[t_next] * em2h * x0)
            if second:
                new = new + alphas[t_next] * (0.5 * em2h / r) * (x0 - x0_prev)
            img = new + sigmas[t_next] * torch.sqrt(em2h) * z
        else:
            D = x0
            if second:
                D = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * x0_prev
            img = (sigmas[t_next] / sigmas[t]) * img \
                - alphas[t_next] * torch.expm1(-h) * D
        x0_prev, h_prev = x0, h
        if continous:
            snaps.append(img)
    if continous:
        return img, torch.stack(snaps, dim=0)
    return img
