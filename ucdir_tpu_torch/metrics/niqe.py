"""NIQE, the Natural Image Quality Evaluator (no reference). Counterpart of
`ucdir_tpu/metrics/niqe.py` (reference: metric/niqe.py:
10-196, the BasicSR port of the official MATLAB release): the port's own
copy of that numpy and scipy code.

MSCN normalization with a 7x7 Gaussian, AGGD parameter fits of the
normalized coefficients and their four neighbor-products per 96x96 block at
two scales, then the Mahalanobis-style distance between the fitted MVG and
the pristine-model MVG. `niqe_pris_params.npz` (beside this file, a byte
copy of the JAX package's) is the official pristine-model statistics (mu,
covariance, window) that BasicSR and the reference ship: a public data
file, not code.

`convert_to='y'` expects the channel order the caller loads: pass bgr=True
for cv2-loaded BGR images.
"""
from __future__ import annotations

import math
import os

import numpy as np
from scipy.ndimage import correlate
from scipy.special import gamma as _gamma_fn

_PARAMS_PATH = os.path.join(os.path.dirname(__file__), 'niqe_pris_params.npz')

# precomputed lookup for the AGGD shape-parameter search
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (np.square(_gamma_fn(2.0 / _GAM)) /
          (_gamma_fn(1.0 / _GAM) * _gamma_fn(3.0 / _GAM)))


def estimate_aggd_param(block: np.ndarray):
    """Fit an Asymmetric Generalized Gaussian to the block's coefficients."""
    block = block.flatten()
    left_std = np.sqrt(np.mean(block[block < 0] ** 2))
    right_std = np.sqrt(np.mean(block[block > 0] ** 2))
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block))) ** 2 / (np.mean(block ** 2) + 1e-10)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2)
    pos = np.argmin((_R_GAM - rhatnorm) ** 2)
    alpha = _GAM[pos]
    beta_l = left_std * np.sqrt(_gamma_fn(1 / alpha) / _gamma_fn(3 / alpha))
    beta_r = right_std * np.sqrt(_gamma_fn(1 / alpha) / _gamma_fn(3 / alpha))
    return alpha, beta_l, beta_r


def compute_feature(block: np.ndarray):
    """18 AGGD features: direct + 4 neighbor-product orientations."""
    feat = []
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2])
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (_gamma_fn(2 / alpha) / _gamma_fn(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def niqe(img: np.ndarray, mu_pris_param, cov_pris_param, gaussian_window,
         block_size_h: int = 96, block_size_w: int = 96) -> float:
    assert img.ndim == 2, 'expects a gray/Y image (h, w)'
    h, w = img.shape
    if block_size_h > min(h, w):
        block_size_h = block_size_w = min(h, w)
    num_block_h = math.floor(h / block_size_h)
    num_block_w = math.floor(w / block_size_w)
    img = img[:num_block_h * block_size_h, :num_block_w * block_size_w]

    distparam = []
    for scale in (1, 2):
        mu = correlate(img, gaussian_window, mode='nearest')
        sigma = np.sqrt(np.abs(
            correlate(np.square(img), gaussian_window, mode='nearest')
            - np.square(mu)))
        normalized = (img - mu) / (sigma + 1)

        feat = []
        for idx_w in range(num_block_w):
            for idx_h in range(num_block_h):
                block = normalized[
                    idx_h * block_size_h // scale:(idx_h + 1) * block_size_h // scale,
                    idx_w * block_size_w // scale:(idx_w + 1) * block_size_w // scale]
                feat.append(compute_feature(block))
        distparam.append(np.array(feat))

        if scale == 1:
            import cv2
            hh, ww = img.shape
            img = cv2.resize(img / 255., (ww // 2, hh // 2),
                             interpolation=cv2.INTER_LINEAR) * 255.

    distparam = np.concatenate(distparam, axis=1)
    mu_distparam = np.nanmean(distparam, axis=0)
    distparam_no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_distparam = np.cov(distparam_no_nan, rowvar=False)

    invcov_param = np.linalg.pinv((cov_pris_param + cov_distparam) / 2)
    d = mu_pris_param - mu_distparam
    return float(np.sqrt(np.squeeze(d @ invcov_param @ d.T)))


def calculate_niqe(img: np.ndarray, crop_border: int = 0,
                   input_order: str = 'HWC', convert_to: str = 'y',
                   bgr: bool = False) -> float:
    params = np.load(_PARAMS_PATH)
    mu_pris_param = params['mu_pris_param']
    cov_pris_param = params['cov_pris_param']
    gaussian_window = params['gaussian_window']

    img = np.asarray(img).astype(np.float32)
    if input_order != 'HW':
        if input_order == 'CHW':
            img = img.transpose(1, 2, 0)
        if convert_to == 'y':
            from ucdir_tpu_torch.metrics.ssim import to_y_channel
            if bgr:
                img = img[..., ::-1]  # to RGB for our converter
            img = to_y_channel(img)
        elif convert_to == 'gray':
            import cv2
            code = cv2.COLOR_BGR2GRAY if bgr else cv2.COLOR_RGB2GRAY
            img = cv2.cvtColor(img / 255., code) * 255.
        img = np.squeeze(img)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe(img, mu_pris_param, cov_pris_param, gaussian_window)
