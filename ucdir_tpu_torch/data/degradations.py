"""Degradation synthesis: blur kernels, noise, JPEG. Counterpart of
`ucdir_tpu/data/degradations.py`, in two halves by where they run:

  * HOST (numpy and scipy, per item in the dataset's workers; a copy of the
    JAX package's host half): the kernel generators (bivariate iso/aniso/
    generalized/plateau Gaussians, reference degradations.py:98-523, sinc
    :529-549), the numpy noises (:559-872) and cv2 JPEG (:994-1030).
  * DEVICE (torch, batched, on the trainer's device; NHWC like the rest of
    the port): filter2D (:13-37), USMSharp (:69-89), the batched gaussian
    and poisson noises (the `_pt` functions :600-872) and torch's own
    F.interpolate. These compose into the Real-SR feed (realsr.py).

Draws: each `_pt` function takes a `generator` (a torch.Generator on the
image's device) or `draws`, the dict of its draws that `gaussian_noise_draws`
or `poisson_noise_draws` makes from a generator. So tests can inject the JAX
package's draws, and two devices can run on the same draws.

Hard rounding: the poisson noise rounds `clip(x * 255)` to 256 levels
before it draws, and the clip-and-round of `rounds=True` rounds again. A sum
in another order than the JAX package's (a convolution, a resize) can move a
value across a level boundary, which then differs by one 1/255 level.
"""
from __future__ import annotations

import functools
import math
import random
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import special

# ===========================================================================
# HOST: blur kernel generation (numpy, matches reference math)
# ===========================================================================


def sigma_matrix2(sig_x, sig_y, theta):
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def mesh_grid(kernel_size):
    ax = np.arange(-kernel_size // 2 + 1., kernel_size // 2 + 1.)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack((xx.reshape(-1, 1), yy.reshape(-1, 1))
                   ).reshape(kernel_size, kernel_size, 2)
    return xy, xx, yy


def pdf2(sigma_matrix, grid):
    inv = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum((grid @ inv) * grid, 2))


def bivariate_Gaussian(kernel_size, sig_x, sig_y, theta, grid=None,
                       isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    sm = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]]) if isotropic \
        else sigma_matrix2(sig_x, sig_y, theta)
    kernel = pdf2(sm, grid)
    return kernel / np.sum(kernel)


def bivariate_generalized_Gaussian(kernel_size, sig_x, sig_y, theta, beta,
                                   grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    sm = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]]) if isotropic \
        else sigma_matrix2(sig_x, sig_y, theta)
    inv = np.linalg.inv(sm)
    kernel = np.exp(-0.5 * np.power(np.sum((grid @ inv) * grid, 2), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, grid=None,
                      isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    sm = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]]) if isotropic \
        else sigma_matrix2(sig_x, sig_y, theta)
    inv = np.linalg.inv(sm)
    kernel = np.reciprocal(np.power(np.sum((grid @ inv) * grid, 2), beta) + 1)
    return kernel / np.sum(kernel)


def _rand_sig_rot(sigma_x_range, sigma_y_range, rotation_range, isotropic):
    sigma_x = np.random.uniform(*sigma_x_range)
    if isotropic:
        return sigma_x, sigma_x, 0
    return (sigma_x, np.random.uniform(*sigma_y_range),
            np.random.uniform(*rotation_range))


def _rand_beta(beta_range):
    if np.random.uniform() < 0.5:
        return np.random.uniform(beta_range[0], 1)
    return np.random.uniform(1, beta_range[1])


def _mult_noise(kernel, noise_range):
    if noise_range is not None:
        kernel = kernel * np.random.uniform(*noise_range, size=kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                              rotation_range, noise_range=None, isotropic=True,
                              return_sigma=False):
    sx, sy, rot = _rand_sig_rot(sigma_x_range, sigma_y_range, rotation_range,
                                isotropic)
    kernel = _mult_noise(
        bivariate_Gaussian(kernel_size, sx, sy, rot, isotropic=isotropic),
        noise_range)
    return (kernel, [sx, sy]) if return_sigma else kernel


def random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          beta_range, noise_range=None,
                                          isotropic=True, return_sigma=False):
    sx, sy, rot = _rand_sig_rot(sigma_x_range, sigma_y_range, rotation_range,
                                isotropic)
    kernel = _mult_noise(
        bivariate_generalized_Gaussian(kernel_size, sx, sy, rot,
                                       _rand_beta(beta_range),
                                       isotropic=isotropic), noise_range)
    return (kernel, [sx, sy]) if return_sigma else kernel


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                             rotation_range, beta_range, noise_range=None,
                             isotropic=True, return_sigma=False):
    sx, sy, rot = _rand_sig_rot(sigma_x_range, sigma_y_range, rotation_range,
                                isotropic)
    kernel = _mult_noise(
        bivariate_plateau(kernel_size, sx, sy, rot, _rand_beta(beta_range),
                          isotropic=isotropic), noise_range)
    return (kernel, [sx, sy]) if return_sigma else kernel


def random_mixed_kernels(kernel_list, kernel_prob, kernel_size=21,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         betag_range=(0.5, 8), betap_range=(0.5, 8),
                         noise_range=None, return_sigma=False):
    kernel_type = random.choices(kernel_list, kernel_prob)[0]
    common = dict(noise_range=noise_range, return_sigma=return_sigma)
    if kernel_type == 'iso':
        return random_bivariate_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            isotropic=True, **common)
    if kernel_type == 'aniso':
        return random_bivariate_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            isotropic=False, **common)
    if kernel_type == 'generalized_iso':
        return random_bivariate_generalized_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, isotropic=True, **common)
    if kernel_type == 'generalized_aniso':
        return random_bivariate_generalized_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, isotropic=False, **common)
    if kernel_type == 'plateau_iso':
        return random_bivariate_plateau(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betap_range, noise_range=None, isotropic=True,
            return_sigma=return_sigma)
    if kernel_type == 'plateau_aniso':
        return random_bivariate_plateau(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betap_range, noise_range=None, isotropic=False,
            return_sigma=return_sigma)
    raise ValueError(kernel_type)


def circular_lowpass_kernel(cutoff, kernel_size, pad_to=0):
    """2-D sinc filter (reference :529-549)."""
    assert kernel_size % 2 == 1
    c = (kernel_size - 1) / 2
    with np.errstate(divide='ignore', invalid='ignore'):
        kernel = np.fromfunction(
            lambda x, y: cutoff * special.j1(
                cutoff * np.sqrt((x - c) ** 2 + (y - c) ** 2)) /
            (2 * np.pi * np.sqrt((x - c) ** 2 + (y - c) ** 2)),
            [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = \
        cutoff ** 2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        p = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((p, p), (p, p)))
    return kernel


# ===========================================================================
# HOST: numpy noise + JPEG
# ===========================================================================


def _apply_clip_rounds(out, clip, rounds, xp=np):
    if clip and rounds:
        return xp.clip((out * 255.0).round(), 0, 255) / 255.
    if clip:
        return xp.clip(out, 0, 1)
    if rounds:
        return (out * 255.0).round() / 255.
    return out


def generate_gaussian_noise(img, sigma=10, gray_noise=False):
    if gray_noise:
        noise = np.float32(np.random.randn(*img.shape[:2])) * sigma / 255.
        noise = np.repeat(noise[:, :, None], 3, axis=2)
    else:
        noise = np.float32(np.random.randn(*img.shape)) * sigma / 255.
    return noise


def add_gaussian_noise(img, sigma=10, clip=True, rounds=False,
                       gray_noise=False):
    return _apply_clip_rounds(img + generate_gaussian_noise(img, sigma,
                                                            gray_noise),
                              clip, rounds)


def random_add_gaussian_noise(img, sigma_range=(0, 1.0), gray_prob=0,
                              clip=True, rounds=False):
    sigma = np.random.uniform(*sigma_range)
    gray = np.random.uniform() < gray_prob
    return _apply_clip_rounds(
        img + generate_gaussian_noise(img, sigma, gray), clip, rounds)


def generate_poisson_noise(img, scale=1.0, gray_noise=False):
    if gray_noise:
        gray = img @ np.array([0.299, 0.587, 0.114], img.dtype)  # rgb luma
        base = gray
    else:
        base = img
    base = np.clip((base * 255.0).round(), 0, 255) / 255.
    vals = len(np.unique(base))
    vals = 2 ** np.ceil(np.log2(vals))
    out = np.float32(np.random.poisson(base * vals) / float(vals))
    noise = out - base
    if gray_noise:
        noise = np.repeat(noise[:, :, None], 3, axis=2)
    return noise * scale


def add_poisson_noise(img, scale=1.0, clip=True, rounds=False,
                      gray_noise=False):
    return _apply_clip_rounds(img + generate_poisson_noise(img, scale,
                                                           gray_noise),
                              clip, rounds)


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0,
                             clip=True, rounds=False):
    scale = np.random.uniform(*scale_range)
    gray = np.random.uniform() < gray_prob
    return _apply_clip_rounds(
        img + generate_poisson_noise(img, scale, gray), clip, rounds)


def random_add_speckle_noise(img, speckle_std):
    """multiplicative speckle (reference :877-894): out = img + img*N(0,std)."""
    std = np.random.uniform(speckle_std[0], speckle_std[1]) \
        if isinstance(speckle_std, (tuple, list)) else speckle_std
    noise = np.random.normal(0, std / 255., img.shape).astype(np.float32)
    return np.clip(img + img * noise, 0, 1)


def random_add_saltpepper_noise(img, amount, svsp):
    """salt & pepper (reference :909-931): `amount` fraction flipped,
    `svsp` salt-vs-pepper ratio."""
    a = np.random.uniform(amount[0], amount[1]) \
        if isinstance(amount, (tuple, list)) else amount
    s = np.random.uniform(svsp[0], svsp[1]) \
        if isinstance(svsp, (tuple, list)) else svsp
    out = img.copy()
    flip = np.random.rand(*img.shape[:2])
    out[flip < a * s] = 1.
    out[(flip >= a * s) & (flip < a)] = 0.
    return np.clip(out, 0, 1)


def random_add_screen_noise(img, linewidth=(1, 3), space=(20, 60)):
    """CRT-style dark scanlines (reference :963-991 family)."""
    lw = np.random.randint(linewidth[0], linewidth[1] + 1)
    sp = np.random.randint(space[0], space[1] + 1)
    out = img.copy()
    h = img.shape[0]
    for y in range(0, h, sp):
        out[y:y + lw] *= np.random.uniform(0.5, 0.9)
    return np.clip(out, 0, 1)


def add_jpg_compression(img, quality=90):
    """cv2 JPEG round-trip on a [0,1] float image (reference :994-1012)."""
    import cv2
    img = np.clip(img, 0, 1)
    ok, enc = cv2.imencode('.jpg', (img * 255.).astype(np.uint8),
                           [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    return np.float32(cv2.imdecode(enc, 1)) / 255.


def random_add_jpg_compression(img, quality_range=(90, 100), return_q=False):
    q = np.random.uniform(*quality_range)
    out = add_jpg_compression(img, q)
    return (out, q) if return_q else out


# ===========================================================================
# DEVICE: batched torch ops (NHWC, draws from a generator or injected)
# ===========================================================================


def filter2D(img, kernel):
    """Per-sample 2-D filtering (reference :13-37), reflect padding, odd k.

    img: (b, h, w, c); kernel: (b, k, k) or (1, k, k), one for every
    sample. A grouped convolution over the b * c planes as (1, b * c, h, w),
    as the reference runs per-sample kernels. (The reference filters with
    one kernel as a batch of one-channel images instead, which cuDNN runs
    as an implicit GEMM several times slower than PyTorch's depthwise
    kernel on the card; the sum is the same.)"""
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError('Wrong kernel size')
    b, h, w, c = img.shape
    pad = k // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode='reflect')
    ph, pw = x.shape[-2:]
    weight = kernel.to(img).view(-1, 1, 1, k, k).expand(b, c, 1, k, k)
    out = F.conv2d(x.reshape(1, b * c, ph, pw),
                   weight.reshape(b * c, 1, k, k), groups=b * c)
    return out.view(b, c, h, w).permute(0, 2, 3, 1)


def gaussian_kernel_2d(radius: int, sigma: float = 0) -> np.ndarray:
    """cv2.getGaussianKernel outer product (sigma=0 -> cv2's auto sigma)."""
    if radius % 2 == 0:
        radius += 1
    if sigma <= 0:
        sigma = 0.3 * ((radius - 1) * 0.5 - 1) + 0.8
    x = np.arange(radius, dtype=np.float64) - (radius - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = (k / k.sum()).astype(np.float32)
    return np.outer(k, k)


@functools.lru_cache(maxsize=None)
def _usm_kernel(radius, sigma, device):
    """gaussian_kernel_2d as a (1, k, k) float32 tensor on `device`, copied
    there once: a copy at every call would wait for the device."""
    return torch.from_numpy(gaussian_kernel_2d(radius, sigma))[None].to(
        device)


@functools.lru_cache(maxsize=None)
def _gray_weights(device, dtype):
    return torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=device)


def usm_sharp(img, weight: float = 0.5, radius: int = 50, sigma: float = 0,
              threshold: float = 10):
    """Batched USM sharpening (reference USMSharp :69-89). img: (b,h,w,c).
    The threshold mask is a step function: a residual within float error of
    the threshold can fall on either side of it."""
    kernel = _usm_kernel(radius, sigma, img.device)
    blur = filter2D(img, kernel)
    residual = img - blur
    mask = (torch.abs(residual) * 255 > threshold).to(img.dtype)
    soft_mask = filter2D(mask, kernel)
    sharp = torch.clamp(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def _rgb_to_gray(img):
    return torch.sum(img * _gray_weights(img.device, img.dtype), dim=-1,
                     keepdim=True)


def _uniform(shape, lo, hi, like, generator):
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device) * (hi - lo) + lo


def gaussian_noise_draws(img, sigma_range, generator=None):
    """The draws of `random_add_gaussian_noise_pt`, in this order: 'sigma'
    (b,1,1,1) in sigma_range, 'gray' (b,1,1,1) uniform in [0, 1) (gray
    noise where below gray_prob), 'noise' like img and 'noise_gray'
    (b,h,w,1), standard normal."""
    b = img.shape[0]
    d = {'sigma': _uniform((b, 1, 1, 1), sigma_range[0], sigma_range[1], img,
                           generator),
         'gray': _uniform((b, 1, 1, 1), 0., 1., img, generator)}
    for name, shape in (('noise', img.shape),
                        ('noise_gray', img.shape[:3] + (1,))):
        d[name] = torch.randn(shape, generator=generator, dtype=img.dtype,
                              device=img.device)
    return d


def random_add_gaussian_noise_pt(img, sigma_range=(0, 1.0), gray_prob=0,
                                 clip=True, rounds=False,
                                 generator: Optional[torch.Generator] = None,
                                 draws: Optional[dict] = None):
    """Batched gaussian noise (reference :685-702). img: (b,h,w,c); draws
    as `gaussian_noise_draws` gives them (None: drawn from generator)."""
    d = draws if draws is not None else gaussian_noise_draws(
        img, sigma_range, generator)
    sigma = d['sigma']
    gray = (d['gray'] < gray_prob).to(img.dtype)
    noise = d['noise'] * sigma / 255.
    noise_g = d['noise_gray'] * sigma / 255.
    noise = noise * (1 - gray) + noise_g * gray
    return _apply_clip_rounds(img + noise, clip, rounds, xp=torch)


def _unique_vals_pow2(img):
    """2^ceil(log2(#unique levels)) per sample, counted on the 255-level
    rounding of img by a per-sample bincount on the device (a scatter-add,
    which needs no host sync; reference :783-796 counts torch.unique)."""
    b = img.shape[0]
    levels = torch.round(torch.clamp(img * 255., 0, 255)).long().reshape(
        b, -1)
    counts = torch.zeros((b, 256), dtype=torch.int64, device=img.device)
    counts.scatter_add_(1, levels, torch.ones_like(levels))
    nuniq = (counts > 0).sum(dim=1).to(torch.float32)
    return 2.0 ** torch.ceil(torch.log2(nuniq))


def _poisson_rates(x):
    """x rounded to 256 levels, and the counts' per-sample scale vals."""
    xr = torch.round(torch.clamp(x * 255., 0, 255)) / 255.
    return xr, _unique_vals_pow2(xr).reshape(-1, 1, 1, 1)


def _gray_image(img):
    return _rgb_to_gray(img).expand(img.shape)


def poisson_noise_draws(img, scale_range, generator=None):
    """The draws of `random_add_poisson_noise_pt`, in this order: 'scale'
    (b,1,1,1) in scale_range, 'gray' (b,1,1,1) uniform in [0, 1),
    'counts' like img, Poisson at rate xr * vals (xr: img rounded to 256
    levels, vals: `_unique_vals_pow2` of xr), and 'counts_gray' like img,
    the same for the gray image broadcast to every channel (each channel's
    count drawn apart, as the JAX package draws them)."""
    b = img.shape[0]
    d = {'scale': _uniform((b, 1, 1, 1), scale_range[0], scale_range[1],
                           img, generator),
         'gray': _uniform((b, 1, 1, 1), 0., 1., img, generator)}
    for name, x in (('counts', img), ('counts_gray', _gray_image(img))):
        xr, vals = _poisson_rates(x)
        d[name] = torch.poisson(xr * vals, generator=generator)
    return d


def random_add_poisson_noise_pt(img, scale_range=(0, 1.0), gray_prob=0,
                                clip=True, rounds=False,
                                generator: Optional[torch.Generator] = None,
                                draws: Optional[dict] = None):
    """Batched poisson noise (reference :855-872). img: (b,h,w,c); draws
    as `poisson_noise_draws` gives them (None: drawn from generator)."""
    d = draws if draws is not None else poisson_noise_draws(
        img, scale_range, generator)
    gray = (d['gray'] < gray_prob).to(img.dtype)

    def poisson_noise(x, counts):
        xr, vals = _poisson_rates(x)
        return counts.to(x.dtype) / vals - xr

    noise = poisson_noise(img, d['counts'])
    noise_g = poisson_noise(_gray_image(img), d['counts_gray'])
    noise = noise * (1 - gray) + noise_g * gray
    return _apply_clip_rounds(img + noise * d['scale'], clip, rounds,
                              xp=torch)


def interpolate(img, scale_factor=None, size=None, mode='bilinear'):
    """torch's F.interpolate on NHWC (area, bilinear, bicubic; antialias
    off, align_corners False), which the JAX package's resize matches. The
    caller's scale_factor is passed through: torch maps coordinates by it,
    not by the size computed from it."""
    b, h, w, c = img.shape
    if size is None:
        oh, ow = int(h * scale_factor), int(w * scale_factor)
    else:
        oh, ow = size
    if (oh, ow) == (h, w) and mode != 'area':
        return img
    x = img.permute(0, 3, 1, 2)
    if size is None:
        out = F.interpolate(x, scale_factor=scale_factor, mode=mode)
    else:
        out = F.interpolate(x, size=(oh, ow), mode=mode)
    return out.permute(0, 2, 3, 1)
