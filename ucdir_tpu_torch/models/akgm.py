"""Adaptive Kernel Guidance Module — `ResnetBlockDY3h`. Counterpart of
`ucdir_tpu/models/akgm.py` (reference: model/ucdir.py:103-140).

  attw = noise_func(time_emb)                       (B, nset) mixing weights
  h    = swish(conv1(norm1(x)))                     K2, norm folded in
  g    = conv2(resize(guide))                       (B, H, W, nset) maps
  out  = swish(mix(spdyconv(norm2(h)), g * attw)) + res_conv(x)   K1 (+K3)

`tail` selects how the last line runs: 'fused' (K1, one pass), 'mix' (the
affine and g * attw as tensor ops, the mix alone as K8, swish and the
residual as tensor ops) or 'packed' (K9, the group-packed form, which pairs
candidates and input groups differently and so computes another network).

Both GroupNorm(1) layers fold into the following kernel as a per-(batch,
channel) affine x * a + t; their statistics come chained from the producer of
x and h (`in_stats`, conv1's emitted sums) or, where the chain is void, from
kernel K4.

The block computes in the dtype of its parameters and input: float32, or
bfloat16 (validation under `--compute_dtype bf16`), where only the 'fused'
tail has its kernel's bf16 form (K8 and K9 take float32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ucdir_tpu_torch.models.layers import Conv1, Conv3, SimpleGate, cached
from ucdir_tpu_torch.ops.akgm import (akgm_block_tail,
                                      akgm_block_tail_packed, akgm_mix,
                                      pack_grouped_weight)
from ucdir_tpu_torch.ops.conv import swish
from ucdir_tpu_torch.ops.stats import gn1_stats

TAILS = ('fused', 'mix', 'packed')


def totals(stats):
    """(B, C) per-channel sums -> (B,) totals, the GroupNorm(1) statistics."""
    s, q = stats
    return s.sum(dim=1), q.sum(dim=1)


def norm1_affine_f32(x, scale, bias, totals_=None, eps: float = 1e-5):
    """GroupNorm(num_groups=1) as a per-(batch, channel) affine: returns
    float32 (a, t) with norm(x) == x * a + t. totals_: the chained ((B,)
    sum, (B,) sumsq) of x, or None to take them with one pass of K4. One-pass
    variance E[x^2] - mean^2 in float32, as the JAX package computes it."""
    n = x.shape[1] * x.shape[2] * x.shape[3]
    s_tot, q_tot = totals_ if totals_ is not None else totals(gn1_stats(x))
    mean = s_tot / n
    var = q_tot / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    scale, bias = scale.float(), bias.float()
    a = scale[None, :] * rstd[:, None]
    t = bias[None, :] - mean[:, None] * rstd[:, None] * scale[None, :]
    return a.contiguous(), t.contiguous()


def norm1_affine(x, scale, bias, totals_=None, eps: float = 1e-5):
    """`norm1_affine_f32` rounded to x's dtype: the affine that a kernel
    folds (`_norm1_affine` of ucdir_tpu/models/akgm.py)."""
    a, t = norm1_affine_f32(x, scale, bias, totals_, eps)
    return a.to(x.dtype), t.to(x.dtype)


def group_norm1(x, a, t):
    """x * a + t in float32 for float32 (a, t) of `norm1_affine_f32`,
    rounded to x's dtype: GroupNorm(1) applied outside a kernel, as flax's
    GroupNorm normalizes a bfloat16 input."""
    return (x.float() * a[:, None, None, :] + t[:, None, None, :]).to(x.dtype)


def guide_maps(block: 'ResnetBlockDY3h', guide, size):
    """The block's spatial attention maps from the guide image resized to
    `size` (bilinear, no antialias): conv1x1 -> SimpleGate -> conv3x3."""
    if tuple(guide.shape[1:3]) != tuple(size):
        guide = F.interpolate(guide.permute(0, 3, 1, 2), size=tuple(size),
                              mode='bilinear', align_corners=False,
                              antialias=False).permute(0, 2, 3, 1)
    g = block.conv2(guide.permute(0, 3, 1, 2))
    return g.permute(0, 2, 3, 1).contiguous()


class ResnetBlockDY3h(nn.Module):
    def __init__(self, dim: int, dim_out: int, nl_emb_dim: int,
                 norm_groups: int = 1, nset: int = 8, tail: str = 'fused'):
        super().__init__()
        if norm_groups != 1:
            raise NotImplementedError(
                'ResnetBlockDY3h: only norm_groups=1 (the shipped configs) is '
                'ported; see ROADMAP.md')
        if tail not in TAILS:
            raise ValueError('tail must be one of %s, got %r' % (TAILS, tail))
        self.dim, self.dim_out, self.nset = dim, dim_out, nset
        self.tail = tail
        self.noise_func = nn.Sequential(nn.Linear(nl_emb_dim, nset), nn.SiLU(),
                                        nn.Linear(nset, nset))
        self.norm1 = nn.GroupNorm(1, dim)
        self.conv1 = Conv3(dim, dim_out)
        self.norm2 = nn.GroupNorm(1, dim_out)
        self.conv2 = nn.Sequential(nn.Conv2d(3, 2 * nset, 1), SimpleGate(),
                                   nn.Conv2d(nset, nset, 3, padding=1))
        self.spdyconv = nn.Conv2d(dim_out, dim_out * nset, 3, padding=1,
                                  groups=nset)
        self.res_conv = (Conv1(dim, dim_out) if dim != dim_out
                         else nn.Identity())

    def spdy_weight(self):
        """The grouped kernel as (9 * C/G, C * G): row tap * C/G + ci."""
        w = self.spdyconv.weight
        return cached(self, 'spdy', lambda: w.permute(2, 3, 1, 0).reshape(
            -1, w.shape[0]), w)

    def packed_weight(self):
        """The grouped kernel as the packed tail's dense (9 * C, C)."""
        return cached(self, 'packed', lambda: pack_grouped_weight(
            self.spdy_weight(), self.nset), self.spdyconv.weight)

    def forward(self, x, time_emb, guide, g_maps=None, in_stats=None):
        """x (B, H, W, dim) NHWC; in_stats: chained ((B,) sum, (B,) sumsq) of
        x or None. Returns (out, ((B,) sum, (B,) sumsq) of out)."""
        if x.dtype != torch.float32 and self.tail != 'fused':
            raise NotImplementedError(
                "tail=%r in %s: the kernel of this tail takes float32 only; "
                "see ROADMAP.md" % (self.tail, x.dtype))
        attw = self.noise_func(time_emb)                        # (B, nset)
        a1, t1 = norm1_affine(x, self.norm1.weight, self.norm1.bias, in_stats)
        h, h_stats = self.conv1(x, act='swish', norm_scale=a1, norm_shift=t1,
                                emit_stats=True)
        a2, t2 = norm1_affine(h, self.norm2.weight, self.norm2.bias,
                              totals(h_stats))
        if g_maps is None:
            g_maps = guide_maps(self, guide, x.shape[1:3])
        res = self.res_conv(x)
        attw = attw.contiguous()
        if self.tail == 'fused':
            out, out_stats = akgm_block_tail(
                h, g_maps, self.spdy_weight(), self.spdyconv.bias, res,
                self.nset, norm_scale=a2, norm_shift=t2, attw=attw,
                emit_stats=True)
            return out, totals(out_stats)
        if self.tail == 'mix':
            hh = h * a2[:, None, None, :] + t2[:, None, None, :]
            y = akgm_mix(hh, g_maps * attw[:, None, None, :],
                         self.spdy_weight(), self.spdyconv.bias, self.nset)
            out = swish(y) + res
        else:
            out = akgm_block_tail_packed(
                h, g_maps, self.packed_weight(), self.spdyconv.bias, res,
                self.nset, norm_scale=a2, norm_shift=t2, attw=attw)
        # neither kernel emits statistics: one pass of K4 over the output
        return out, totals(gn1_stats(out))

