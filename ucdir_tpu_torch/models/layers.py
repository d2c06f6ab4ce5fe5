"""Shared building blocks on NHWC tensors. Counterpart of
`ucdir_tpu/models/layers.py`.

The convolution modules keep the reference's parameter names and OIHW
layout (`weight`, `bias`), so a reference state dict loads unchanged; each
repacks its weight into the kernel layout: under autograd as a differentiable
view or copy, so the parameter gets its gradient, and without it once, cached
until the parameter changes (`load_state_dict`, `.to()`, any in-place
update). A tensor that stands in for a parameter (the bf16 cast that a
mixed-precision train step hands `torch.func.functional_call`) is never
cached: its layout is built anew from it at every call.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ucdir_tpu_torch.ops.conv import (conv1x1, conv3x3, pack_up_kernel,
                                      upconv2x)


def simple_gate(x, dim=-1):
    x1, x2 = torch.chunk(x, 2, dim=dim)
    return x1 * x2


class SimpleGate(nn.Module):
    """simple_gate over the channels of an NCHW tensor."""

    def forward(self, x):
        return simple_gate(x, dim=1)


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    # numpy's 'reflect' keeps reflecting for pads longer than the axis,
    # where torch's F.pad refuses them
    idx = np.pad(np.arange(n), (before, after), mode='reflect')
    return torch.as_tensor(idx, device=device)


def reflect_pad(x, top: int, bottom: int, left: int, right: int):
    """Reflect-pads the two spatial axes of NHWC `x` like `jnp.pad(...,
    mode='reflect')`, for any pad length."""
    if top or bottom:
        x = x.index_select(1, _reflect_index(x.shape[1], top, bottom,
                                             x.device))
    if left or right:
        x = x.index_select(2, _reflect_index(x.shape[2], left, right,
                                             x.device))
    return x


def pad_to_multiple(x, fac: int):
    """Reflect-pads bottom and right to a multiple of `fac`, always adding at
    least one pixel (a full `fac` when already divisible), as the reference
    does (ucdir.py:303-307). Returns (x, (padh, padw))."""
    h, w = x.shape[1], x.shape[2]
    padh, padw = (h // fac + 1) * fac - h, (w // fac + 1) * fac - w
    return reflect_pad(x, 0, padh, 0, padw), (padh, padw)


def crop_pad(y, pads):
    padh, padw = pads
    if padh:
        y = y[:, :-padh]
    if padw:
        y = y[:, :, :-padw]
    return y


def cached(module: nn.Module, name: str, fn, *params):
    """The kernel-layout copy `fn()` of `params`. Where autograd is on and a
    parameter requires grad, or where one of `params` is not an
    `nn.Parameter` (a cast standing in for one), it is computed anew, with
    autograd on, so the gradient flows back to the parameter; otherwise
    (validation) it is computed once and kept on `module` until one of
    `params` changes (its storage or its version counter)."""
    if (torch.is_grad_enabled() and any(p.requires_grad for p in params)) \
            or not all(isinstance(p, nn.Parameter) for p in params):
        return fn().contiguous()
    key = tuple((p.data_ptr(), p._version) for p in params)
    store = module.__dict__.setdefault('_kernel_layout', {})
    hit = store.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, fn().contiguous())
        store[name] = hit
    return hit[1]


class PositionalEncoding(nn.Module):
    """Sinusoidal encoding of the continuous noise level (not integer t)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, noise_level):
        noise_level = noise_level.reshape(noise_level.shape[0])
        count = self.dim // 2
        step = torch.arange(count, dtype=noise_level.dtype,
                            device=noise_level.device) / count
        enc = noise_level[:, None] * torch.exp(-math.log(1e4) * step[None, :])
        return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


class Conv3(nn.Conv2d):
    """3x3 SAME convolution on NHWC tensors through kernel K2; parameters as
    nn.Conv2d(cin, cout, 3, stride, padding=1)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride=stride, padding=1)

    def kernel_weight(self):
        """(9 * Cin, Cout), row tap * Cin + ci."""
        return cached(self, 'w', lambda: self.weight.permute(2, 3, 1, 0)
                      .reshape(-1, self.out_channels), self.weight)

    def forward(self, x, act=None, norm_scale=None, norm_shift=None,
                emit_stats=False):
        return conv3x3(x, self.kernel_weight(), self.bias,
                       stride=self.stride[0], act=act,
                       norm_scale=norm_scale, norm_shift=norm_shift,
                       emit_stats=emit_stats)


class Conv1(nn.Conv2d):
    """1x1 convolution on NHWC tensors through kernel K3; parameters as
    nn.Conv2d(cin, cout, 1)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x, act=None):
        w = cached(self, 'w', lambda: self.weight.reshape(
            self.out_channels, self.in_channels).t(), self.weight)
        return conv1x1(x, w, self.bias, act=act)


class Upsample(nn.Module):
    """Nearest x2 then a 3x3 conv (`conv`), as one phase-packed K2 launch at
    the source resolution."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, emit_stats=False):
        c = self.conv
        wp = cached(self, 'w', lambda: pack_up_kernel(
            c.weight.permute(2, 3, 1, 0)).reshape(-1, 4 * c.out_channels),
            c.weight)
        bp = cached(self, 'b', lambda: c.bias.repeat(4), c.bias)
        return upconv2x(x, wp, bp, emit_stats=emit_stats)


class Downsample(nn.Module):
    """Stride-2 3x3 conv (`conv`) through K2."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv3(dim, dim, stride=2)

    def forward(self, x, emit_stats=False):
        return self.conv(x, emit_stats=emit_stats)
