"""Differentiable JPEG in PyTorch. Counterpart of `ucdir_tpu/data/diffjpeg.py`.

Parity target: data/diffjpeg.py:14-491 (the DiffJPEG port with
non-/8-divisible handling): RGB->YCbCr, 2x chroma subsample, 8x8 block split,
DCT, y/c quantization with the standard JPEG tables scaled by the
quality->factor mapping, differentiable (or hard) rounding, dequantize, iDCT,
merge, chroma upsample, YCbCr->RGB, pad-to-16 wrapper.

The 8x8 DCT and iDCT are two small matmuls (M^T B M with the cosine basis)
batched over all blocks, as in the JAX package. Images are NHWC RGB in
[0, 1] on any device; `quality` may be a scalar or one value per sample.

Hard rounding: the quantized DCT coefficients are rounded (`torch.round`,
half to even, as `jnp.round`). A float sum in another order than the JAX
package's can move a coefficient across a rounding boundary, which changes
an output by a whole quantization step; on random inputs that is rare, and
the tests hold this module to the JAX package within 2e-3, the JAX package's
own limit against the reference's DiffJPEG. On the card the matmuls need
TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`, as sr.py sets
it): TF32 products move many coefficients.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# standard JPEG luma/chroma quantization tables (stored transposed like the
# reference so the same (x, y)-indexed block math applies)
Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99]],
    dtype=np.float32).T
C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                            [24, 26, 56, 99], [47, 66, 99, 99]],
                           dtype=np.float32).T

# cosine basis M[x, u] = cos((2x+1) u pi / 16); DCT = scale * (M^T B M)
_M = np.array([[np.cos((2 * x + 1) * u * np.pi / 16) for u in range(8)]
               for x in range(8)], dtype=np.float32)
_ALPHA = np.outer(np.array([1. / np.sqrt(2)] + [1] * 7),
                  np.array([1. / np.sqrt(2)] + [1] * 7)).astype(np.float32)

_RGB2YCC = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                     [0.5, -0.418688, -0.081312]], np.float32).T
_YCC2RGB = np.array([[1., 0., 1.402], [1., -0.344136, -0.714136],
                     [1., 1.772, 0.]], np.float32).T
_CONSTS = {'Y': Y_TABLE, 'C': C_TABLE, 'M': _M, 'alpha': _ALPHA,
           'dct_scale': _ALPHA * 0.25, 'rgb2ycc': _RGB2YCC,
           'ycc2rgb': _YCC2RGB, 'ycc_shift': [0., 128., 128.],
           'rgb_shift': [0., -128., -128.]}


@functools.lru_cache(maxsize=None)
def _device_const(name, device):
    """A constant of this module as float32 on `device`, copied there once:
    a copy at every call would wait for the device each time."""
    return torch.as_tensor(_CONSTS[name], dtype=torch.float32, device=device)


def _const(name, like):
    return _device_const(name, like.device)


def diff_round(x):
    return torch.round(x) + (x - torch.round(x)) ** 3


def quality_to_factor(quality):
    quality = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(quality < 50, 5000. / quality,
                       200. - quality * 2) / 100.


def rgb_to_ycbcr_jpeg(image):
    """NHWC RGB [0,255] -> NHWC YCbCr (full range, JPEG convention)."""
    return image @ _const('rgb2ycc', image) + _const('ycc_shift', image)


def ycbcr_to_rgb_jpeg(image):
    return (image + _const('rgb_shift', image)) @ _const('ycc2rgb', image)


def chroma_subsample(ycbcr):
    """(b,h,w,3) -> y (b,h,w), cb/cr (b,h/2,w/2) via 2x2 mean."""
    y = ycbcr[..., 0]
    b, h, w, _ = ycbcr.shape
    c = ycbcr[..., 1:].reshape(b, h // 2, 2, w // 2, 2, 2).mean(dim=(2, 4))
    return y, c[..., 0], c[..., 1]


def chroma_upsample(y, cb, cr, k: int = 2):
    """The reference's repeat-based 2x upsample (diffjpeg.py:366-375): each
    chroma value repeated over a k x k square."""
    def rep(x):
        return x.repeat_interleave(k, 1).repeat_interleave(k, 2)
    return torch.stack([y, rep(cb), rep(cr)], dim=-1)


def block_split(x, k: int = 8):
    """(b,h,w) -> (b, h/k * w/k, k, k) in the reference's block order."""
    b, h, w = x.shape
    return x.reshape(b, h // k, k, w // k, k).permute(0, 1, 3, 2, 4).reshape(
        b, -1, k, k)


def block_merge(patches, height: int, width: int, k: int = 8):
    b = patches.shape[0]
    return patches.reshape(b, height // k, width // k, k, k).permute(
        0, 1, 3, 2, 4).reshape(b, height, width)


def dct8x8(blocks):
    """(b,n,8,8) spatial -> frequency; scale * (M^T (B-128) M)."""
    M = _const('M', blocks)
    return _const('dct_scale', blocks) * (M.T @ (blocks - 128.) @ M)


def idct8x8(blocks):
    M = _const('M', blocks)
    return 0.25 * (M @ (blocks * _const('alpha', blocks)) @ M.T) + 128.


def _factor_table(table, factor, b):
    table = _const(table, factor)
    if factor.ndim == 0:
        return table * factor
    return table[None, None] * factor.reshape(b, 1, 1, 1)


def compress_jpeg(image, factor, rounding):
    """image: NHWC RGB [0,1] (dims /16). Returns quantized (y, cb, cr)."""
    b = image.shape[0]
    y, cb, cr = chroma_subsample(rgb_to_ycbcr_jpeg(image * 255.))
    out = []
    for comp, table in ((y, 'Y'), (cb, 'C'), (cr, 'C')):
        blocks = dct8x8(block_split(comp))
        out.append(rounding(blocks / _factor_table(table, factor, b)))
    return tuple(out)


def decompress_jpeg(y, cb, cr, imgh: int, imgw: int, factor):
    b = y.shape[0]
    comps = []
    for comp, table, (hh, ww) in (
            (y, 'Y', (imgh, imgw)),
            (cb, 'C', (imgh // 2, imgw // 2)),
            (cr, 'C', (imgh // 2, imgw // 2))):
        deq = comp * _factor_table(table, factor, b)
        comps.append(block_merge(idct8x8(deq), hh, ww))
    image = ycbcr_to_rgb_jpeg(chroma_upsample(*comps))
    return torch.clamp(image, 0., 255.) / 255.


def diff_jpeg(x, quality, differentiable: bool = True):
    """Full JPEG round-trip. x: NHWC RGB [0,1]; quality a scalar or (b,).

    Mirrors DiffJPEG.forward (diffjpeg.py:467-491) incl. the zero pad-to-16.
    """
    rounding = diff_round if differentiable else torch.round
    factor = quality_to_factor(quality).to(x.device)
    b, h, w, _ = x.shape
    h_pad = (16 - h % 16) % 16
    w_pad = (16 - w % 16) % 16
    x = F.pad(x, (0, 0, 0, w_pad, 0, h_pad))
    y, cb, cr = compress_jpeg(x, factor, rounding)
    rec = decompress_jpeg(y, cb, cr, h + h_pad, w + w_pad, factor)
    return rec[:, :h, :w, :]


class DiffJPEG:
    """Callable wrapper matching the reference module API."""

    def __init__(self, differentiable: bool = True):
        self.differentiable = differentiable

    def __call__(self, x, quality):
        return diff_jpeg(x, quality, differentiable=self.differentiable)
