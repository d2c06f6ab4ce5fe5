"""Shared building blocks on NHWC tensors. Counterpart of
`ucdir_tpu/models/layers.py`: the reflect pads, the noise-level encoding,
the convolutions of DY3h, GroupNorm as a per-(batch, channel) affine, the
dropout mask, and the SR3 residual block (`FeatureWiseAffine`, `Block`,
`ResnetBlock`, on kernels K2 and K3) that `DY3h(resname='ResnetBlock')`
runs.

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
                                      swish, upconv2x)
from ucdir_tpu_torch.ops.gn_scope import tile_gn
from ucdir_tpu_torch.ops.stats import gn1_stats
from ucdir_tpu_torch.parallel.mesh import DataShard


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


def group_norm1(x, a, t):
    """x * a + t in float32 for float32 (a, t) of `norm1_affine_f32`
    (models/akgm.py) or `group_affine_f32`, rounded to x's dtype: a
    GroupNorm applied outside a kernel, as flax's GroupNorm normalizes a
    bfloat16 input. Differentiable in x, a and t; a bfloat16 x is saved for
    backward as it is, never as its float32 copy."""
    if x.dtype == torch.float32:
        return x * a[:, None, None, :] + t[:, None, None, :]
    return _GroupNorm1.apply(x, a, t)


class _GroupNorm1(torch.autograd.Function):
    """`group_norm1` of a low-precision x with the gradients of its
    composition (x's float32 copy times a, plus t, rounded): dx the float32
    g * a rounded to x's dtype, da and dt the float32 sums over the pixels
    of g * x and of g. It saves x, not x's float32 copy."""

    @staticmethod
    def forward(ctx, x, a, t):
        ctx.save_for_backward(x, a)
        return (x.float() * a[:, None, None, :]
                + t[:, None, None, :]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, a = ctx.saved_tensors
        g = g.float()
        return ((g * a[:, None, None, :]).to(x.dtype),
                (g * x).sum(dim=(1, 2)), g.sum(dim=(1, 2)))


def group_affine_f32(x, scale, bias, groups: int, eps: float = 1e-5):
    """GroupNorm(groups) of NHWC x as a per-(batch, channel) affine: float32
    (a, t) with norm(x) == x * a + t. The per-channel sums come from one pass
    of kernel K4 and add up per group; the variance is E[x^2] - mean^2 in
    float32, clipped at 0, as flax's GroupNorm takes it. Differentiable in
    x, scale and bias."""
    B, H, W, C = x.shape
    s, q = gn1_stats(x)
    n = H * W * (C // groups)
    mean = s.reshape(B, groups, -1).sum(dim=2) / n
    var = (q.reshape(B, groups, -1).sum(dim=2) / n
           - mean * mean).clamp_min(0.)
    rstd = torch.rsqrt(var + eps).repeat_interleave(C // groups, dim=1)
    mean = mean.repeat_interleave(C // groups, dim=1)
    a = scale.float()[None, :] * rstd
    return a, bias.float()[None, :] - mean * a


def group_norm(x, norm: nn.GroupNorm):
    """`norm` (an nn.GroupNorm, eps 1e-5, its weight and bias) applied to
    NHWC x through `group_affine_f32` and `group_norm1`, in x's dtype."""
    return group_norm1(x, *group_affine_f32(x, norm.weight, norm.bias,
                                            norm.num_groups, norm.eps))


def dropout_mask(x, p: float, generator=None):
    """Inverted-dropout mask for x, in x's dtype: 0 with probability p, else
    1 / (1 - p), drawn in float32 from an explicit generator whatever x's
    dtype, so that a bfloat16 step draws the float32 step's mask. A
    `parallel.mesh.DataShard` in place of the generator draws the global
    batch's mask and keeps this rank's rows."""
    if isinstance(generator, DataShard):
        u = generator.rand(x.shape, device=x.device, dtype=torch.float32)
    else:
        u = torch.rand(x.shape, device=x.device, dtype=torch.float32,
                       generator=generator)
    keep = u >= p
    return keep.to(x.dtype) / (1. - p)


class FeatureWiseAffine(nn.Module):
    """The noise-level embedding into the features: x + Dense(emb), or
    (1 + gamma) * x + beta with use_affine_level. Parameters as the
    reference's `noise_func.0` (an nn.Linear in an nn.Sequential)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_affine_level: bool = False):
        super().__init__()
        self.use_affine_level = use_affine_level
        self.noise_func = nn.Sequential(
            nn.Linear(in_channels, out_channels * (1 + use_affine_level)))

    def forward(self, x, noise_embed):
        h = self.noise_func(noise_embed)[:, None, None, :]
        if self.use_affine_level:
            gamma, beta = torch.chunk(h, 2, dim=-1)
            return (1 + gamma) * x + beta
        return x + h


class Block(nn.Module):
    """GroupNorm(groups) -> swish -> dropout -> 3x3 conv, with the
    reference's parameter names (`block.0` the norm, `block.3` the conv).
    The conv is K2 (the JAX package's is XLA's): its plain version rounds a
    bf16 output where the kernel does, so card and host agree in bf16."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32,
                 dropout: float = 0.0):
        super().__init__()
        self.p = dropout
        self.block = nn.Sequential(
            nn.GroupNorm(groups, dim), nn.SiLU(),
            nn.Dropout(dropout) if dropout else nn.Identity(),
            Conv3(dim, dim_out))

    def forward(self, x, dropout_generator=None, gn_win=None):
        """x (B, H, W, dim) NHWC. In train() mode the dropout mask comes from
        `dropout_generator` (a torch.Generator, a DataShard of one, or None:
        the global generator). gn_win: the GroupNorm(1) window of
        UCDIR_TPU_GN_SCOPE=tile (ops/gn_scope.py) or None."""
        norm = self.block[0]
        if norm.num_groups == 1 and gn_win is not None:
            h = swish(tile_gn(x, norm.weight, norm.bias, gn_win))
        else:
            h = swish(group_norm(x, norm))
        if self.training and self.p > 0:
            h = h * dropout_mask(h, self.p, dropout_generator)
        return self.block[3](h.contiguous())


class ResnetBlock(nn.Module):
    """The SR3 residual block (reference ucdir.py:86-100; `resname:
    ResnetBlock`): Block, the noise-level embedding added, Block with
    dropout, plus the input (through a 1x1 conv, K3, where the width
    changes)."""

    def __init__(self, dim: int, dim_out: int, nl_emb_dim: int,
                 dropout: float = 0.0, use_affine_level: bool = False,
                 norm_groups: int = 32):
        super().__init__()
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.noise_func = FeatureWiseAffine(nl_emb_dim, dim_out,
                                            use_affine_level)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups,
                            dropout=dropout)
        self.res_conv = (Conv1(dim, dim_out) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, time_emb, dropout_generator=None, gn_win=None):
        h = self.noise_func(self.block1(x, gn_win=gn_win), time_emb)
        return (self.block2(h, dropout_generator, gn_win)
                + self.res_conv(x))
