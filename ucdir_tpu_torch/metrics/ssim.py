"""BasicSR-grade PSNR/SSIM with crop-border and Y-channel options.
Counterpart of `ucdir_tpu/metrics/ssim.py` (the port keeps its own copy).

Parity target: metric/ssim.py (calculate_psnr :9-60,
_ssim_cly :175-210, _ssim_3d :139-173, calculate_ssim :213-286) and the color
conversions in metric/utils.py (ITU-R BT.601 YCbCr).

The reference's `_ssim_3d` uses a CUDA Conv3d with replicate padding; here it
is scipy.ndimage.correlate(mode='nearest') — identical arithmetic, float64.
"""
from __future__ import annotations

import numpy as np


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BT.601 full-range rgb->ycbcr on [0,1] float images (BasicSR semantics:
    output Y in [16/255, 235/255] scale when input is [0,1])."""
    img_type = img.dtype
    img = img.astype(np.float64)
    if img_type != np.uint8:
        img *= 255.
    if y_only:
        out = np.dot(img, [65.481 / 255., 128.553 / 255., 24.966 / 255.]) + 16.0
        out = out[..., None]
    else:
        mat = np.array([[65.481, -37.797, 112.0],
                        [128.553, -74.203, -93.786],
                        [24.966, 112.0, -18.214]]) / 255.
        out = np.dot(img, mat) + [16, 128, 128]
    if img_type != np.uint8:
        out /= 255.
    return out.astype(np.float64)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """[0,255] HWC -> Y channel [0,255] HW1 (metric/metric_util.py semantics)."""
    img = img.astype(np.float64) / 255.
    if img.ndim == 3 and img.shape[2] == 3:
        img = rgb2ycbcr(img, y_only=True)
    return img * 255.


def _reorder(img: np.ndarray, input_order: str) -> np.ndarray:
    if input_order == 'CHW':
        return img.transpose(1, 2, 0)
    return img


def calculate_psnr(img1, img2, crop_border: int = 0, input_order: str = 'HWC',
                   test_y_channel: bool = False) -> float:
    assert img1.shape == img2.shape, (img1.shape, img2.shape)
    img1 = _reorder(np.asarray(img1), input_order).astype(np.float64)
    img2 = _reorder(np.asarray(img2), input_order).astype(np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img1, img2 = to_y_channel(img1), to_y_channel(img2)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float('inf')
    max_value = 1. if img1.max() <= 1 else 255.
    return float(20. * np.log10(max_value / np.sqrt(mse)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _ssim_cly(img1: np.ndarray, img2: np.ndarray) -> float:
    """Y-channel SSIM with replicate borders (metric/ssim.py:175-210)."""
    from scipy.ndimage import correlate
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k = _gaussian_window()
    window = np.outer(k, k)

    f = lambda x: correlate(x, window, mode='nearest')
    mu1, mu2 = f(img1), f(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = f(img1 ** 2) - mu1_sq
    sigma2_sq = f(img2 ** 2) - mu2_sq
    sigma12 = f(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def _ssim_3d(img1: np.ndarray, img2: np.ndarray, max_value: float) -> float:
    """3-D Gaussian SSIM over (H, W, C) with replicate padding
    (metric/ssim.py:125-173; separable 11x11x11 kernel)."""
    from scipy.ndimage import correlate
    C1 = (0.01 * max_value) ** 2
    C2 = (0.03 * max_value) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k = _gaussian_window()
    kernel3 = k[:, None, None] * k[None, :, None] * k[None, None, :]

    f = lambda x: correlate(x, kernel3, mode='nearest')
    mu1, mu2 = f(img1), f(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = f(img1 ** 2) - mu1_sq
    sigma2_sq = f(img2 ** 2) - mu2_sq
    sigma12 = f(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def calculate_ssim(img1, img2, crop_border: int = 0, input_order: str = 'HWC',
                   test_y_channel: bool = False) -> float:
    assert img1.shape == img2.shape, (img1.shape, img2.shape)
    img1 = _reorder(np.asarray(img1), input_order).astype(np.float64)
    img2 = _reorder(np.asarray(img2), input_order).astype(np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img1, img2 = to_y_channel(img1), to_y_channel(img2)
        return _ssim_cly(img1[..., 0], img2[..., 0])
    max_value = 1 if img1.max() <= 1 else 255
    return _ssim_3d(img1, img2, max_value)
