"""In-loop metrics + image save helpers. Counterpart of
`ucdir_tpu/metrics/core.py` (the port keeps its own copy).

Parity target: core/metrics.py:8-99. Images here are numpy
NHWC/HWC in [-1, 1] (the reference uses torch CHW); uint8 conversion uses the
same clamp -> [0,1] -> *255 -> round pipeline, and 4-D inputs become a
torchvision-style grid (nrow = floor(sqrt(n)), padding 2).
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np


def make_grid(imgs: np.ndarray, nrow: int, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """(N,H,W,C) in [0,1] -> single HWC grid image (torchvision semantics)."""
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = int(math.ceil(n / ncol))
    H = nrows * (h + padding) + padding
    W = ncol * (w + padding) + padding
    grid = np.full((H, W, c), pad_value, dtype=imgs.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = imgs[i]
    return grid


def tensor2img(arr, out_type=np.uint8, min_max: Tuple[float, float] = (-1, 1)):
    """NHWC/HWC/HW array (any range) -> uint8 HWC (or HW) image.

    4-D inputs with a leading batch of 1 are squeezed; larger batches become a
    grid (reference: core/metrics.py:8-34 with torchvision make_grid).
    """
    arr = np.asarray(arr, dtype=np.float32)
    arr = np.squeeze(arr)
    arr = np.clip(arr, *min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if arr.ndim == 4:
        arr = make_grid(arr, nrow=int(math.sqrt(arr.shape[0])))
    elif arr.ndim not in (2, 3):
        raise TypeError('Only 4D/3D/2D supported, got %dD' % arr.ndim)
    if out_type == np.uint8:
        arr = (arr * 255.0).round()
    return arr.astype(out_type)


def save_img(img: np.ndarray, img_path: str, mode: str = 'RGB'):
    import cv2
    os.makedirs(os.path.dirname(img_path) or '.', exist_ok=True)
    cv2.imwrite(img_path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def save_jpg(img: np.ndarray, img_path: str, mode: str = 'RGB'):
    """quality-100 jpg; renames .png -> .jpg (core/metrics.py:42-45)."""
    import cv2
    img_path = img_path.replace('.png', '.jpg')
    os.makedirs(os.path.dirname(img_path) or '.', exist_ok=True)
    cv2.imwrite(img_path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                [int(cv2.IMWRITE_JPEG_QUALITY), 100])


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """uint8-range PSNR (core/metrics.py:48-55)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float('inf')
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    import cv2
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = np.outer(kernel, kernel.transpose())

    mu1 = cv2.filter2D(img1, -1, window)[5:-5, 5:-5]
    mu2 = cv2.filter2D(img2, -1, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = cv2.filter2D(img1 ** 2, -1, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = cv2.filter2D(img2 ** 2, -1, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = cv2.filter2D(img1 * img2, -1, window)[5:-5, 5:-5] - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style SSIM on uint8-range images (core/metrics.py:58-99)."""
    if img1.shape != img2.shape:
        raise ValueError('Input images must have the same dimensions.')
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return _ssim_single(img1, img2)  # cv2 filters all channels at once
        if img1.shape[2] == 1:
            return _ssim_single(np.squeeze(img1), np.squeeze(img2))
    raise ValueError('Wrong input image dimensions.')
