"""Color-space conversions on (..., 3) tensors: sRGB and linear RGB, XYZ,
Lab and YUV. Counterpart of `ucdir_tpu/utils/color.py` (reference
utils/color.py:4-289). RGB in [0, 1] unless noted; D65 and BT.601
constants. The constants follow the input's dtype and device."""
from __future__ import annotations

import torch

_XYZ_FROM_RGB = [[0.412453, 0.357580, 0.180423],
                 [0.212671, 0.715160, 0.072169],
                 [0.019334, 0.119193, 0.950227]]
_RGB_FROM_XYZ = [[3.240479, -1.537150, -0.498535],
                 [-0.969256, 1.875991, 0.041556],
                 [0.055648, -0.204043, 1.057311]]
_D65 = [0.950456, 1.0, 1.088754]
_YUV_FROM_RGB = [[0.299, 0.587, 0.114],
                 [-0.14713, -0.28886, 0.436],
                 [0.615, -0.51499, -0.10001]]
_RGB_FROM_YUV = [[1.0, 0.0, 1.13983],
                 [1.0, -0.39465, -0.58060],
                 [1.0, 2.03211, 0.0]]


def _mat(x, m):
    """x @ m.T with m a 3 x 3 constant in x's dtype and on x's device."""
    return x @ torch.tensor(m, dtype=x.dtype, device=x.device).T


def srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    x = x.clamp(min=0.)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x ** (1 / 2.4) - 0.055)


def rgb_to_xyz(rgb):
    return _mat(rgb, _XYZ_FROM_RGB)


def xyz_to_rgb(xyz):
    return _mat(xyz, _RGB_FROM_XYZ)


def _lab_f(t):
    d = 6. / 29.
    # the real cube root of t, as jnp.cbrt takes it
    return torch.where(t > d ** 3, torch.sign(t) * t.abs() ** (1. / 3.),
                       t / (3 * d * d) + 4. / 29.)


def _lab_finv(t):
    d = 6. / 29.
    return torch.where(t > d, t ** 3, 3 * d * d * (t - 4. / 29.))


def xyz_to_lab(xyz):
    x, y, z = [xyz[..., i] / _D65[i] for i in range(3)]
    fx, fy, fz = _lab_f(x), _lab_f(y), _lab_f(z)
    return torch.stack([116. * fy - 16., 500. * (fx - fy),
                        200. * (fy - fz)], dim=-1)


def lab_to_xyz(lab):
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.) / 116.
    fx = fy + a / 500.
    fz = fy - b / 200.
    xyz = torch.stack([_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)], dim=-1)
    return xyz * torch.tensor(_D65, dtype=xyz.dtype, device=xyz.device)


def rgb_to_lab(rgb):
    return xyz_to_lab(rgb_to_xyz(srgb_to_linear(rgb)))


def lab_to_rgb(lab):
    return linear_to_srgb(xyz_to_rgb(lab_to_xyz(lab)))


def rgb_to_yuv(rgb):
    return _mat(rgb, _YUV_FROM_RGB)


def yuv_to_rgb(yuv):
    return _mat(yuv, _RGB_FROM_YUV)
