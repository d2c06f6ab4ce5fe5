"""DY3h — the guided diffusion denoiser UNet on NHWC tensors. Counterpart of
`ucdir_tpu/models/dy3h.py` (reference: model/ucdir.py:204-307).

The module tree and parameter names are the reference's (`downs.0`,
`downs.<i>.res_block.*`, `downs.<i>.attn.*`, `downs.<i>.conv.*`, `mid.*`,
`ups.*`, `noise_level_mlp.{1,3}`, `final_conv.{0,3}`), so a reference state
dict loads with `strict=True`.

GroupNorm(1) statistics are chained: every producer kernel (downs_0, each
block's tail, Down/Upsample) emits its output's per-(batch, channel) sums,
the next block's folded norm uses their totals, and totals add across skip
concats. Attention voids the chain; the next norm then takes its statistics
with kernel K4.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ucdir_tpu_torch.models.akgm import (ResnetBlockDY3h, group_norm1,
                                         guide_maps, norm1_affine_f32, totals)
from ucdir_tpu_torch.models.attention import SelfAttention
from ucdir_tpu_torch.models.layers import (Conv3, Downsample,
                                           PositionalEncoding, Upsample,
                                           crop_pad, pad_to_multiple)
from ucdir_tpu_torch.ops.conv import conv3x3_preact, swish


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim: int, dim_out: int, nl_emb_dim: int,
                 norm_groups: int = 1, with_attn: bool = False,
                 tail: str = 'fused'):
        super().__init__()
        self.res_block = ResnetBlockDY3h(dim, dim_out, nl_emb_dim,
                                         norm_groups=norm_groups, tail=tail)
        self.attn = (SelfAttention(dim_out, norm_groups=norm_groups)
                     if with_attn else None)

    def forward(self, x, time_emb, guide, g_maps=None, in_stats=None):
        x, xs = self.res_block(x, time_emb, guide, g_maps, in_stats)
        if self.attn is not None:
            x, xs = self.attn(x), None
        return x, xs


def dropout_mask(x, p: float, generator=None):
    """Inverted-dropout mask for x: 0 with probability p, else 1 / (1 - p),
    drawn from an explicit generator."""
    keep = torch.rand(x.shape, device=x.device, dtype=x.dtype,
                      generator=generator) >= p
    return keep.to(x.dtype) / (1. - p)


def _cat_stats(a, b):
    if a is None or b is None:
        return None
    return a[0] + b[0], a[1] + b[1]


class DY3h(nn.Module):
    def __init__(self, in_channel: int = 6, out_channel: int = 3,
                 inner_channel: int = 32, norm_groups: int = 1,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8),
                 attn_res: Sequence[int] = (8,), res_blocks: int = 3,
                 dropout: float = 0.0, image_size: int = 128,
                 tail: str = 'fused'):
        """tail: how every AKGM block runs its tail, 'fused' | 'mix' |
        'packed' (models/akgm.py). dropout == 0 folds the head into one
        pre-activated conv (K7)."""
        super().__init__()
        self.inner_channel = inner_channel
        self.channel_mults = tuple(channel_mults)
        self.attn_res = tuple(attn_res)
        self.res_blocks = res_blocks
        self.image_size = image_size
        nlc = inner_channel
        self.noise_level_mlp = nn.Sequential(
            PositionalEncoding(nlc), nn.Linear(nlc, nlc * 4), nn.SiLU(),
            nn.Linear(nlc * 4, nlc))

        downs, mid_channel, ups, pre_channel = self._plan()

        def block(dim, dim_out, with_attn):
            return ResnetBlocWithAttn(dim, dim_out, nlc, norm_groups,
                                      with_attn, tail)

        self.downs = nn.ModuleList([Conv3(in_channel, inner_channel)] + [
            block(d, do, a) if kind == 'block' else Downsample(do)
            for kind, d, do, a in downs])
        self.mid = nn.ModuleList([block(mid_channel, mid_channel, True),
                                  block(mid_channel, mid_channel, False)])
        self.ups = nn.ModuleList([
            block(d, do, a) if kind == 'block' else Upsample(do)
            for kind, d, do, a in ups])
        self.final_conv = nn.Sequential(
            nn.GroupNorm(1, pre_channel), nn.SiLU(), nn.Dropout(dropout),
            Conv3(pre_channel, out_channel))

    def _plan(self):
        """Layer plan of the reference constructor loops: downs and ups as
        (kind, dim, dim_out, with_attn), the mid width, the head width."""
        num_mults = len(self.channel_mults)
        now_res = self.image_size
        pre_channel = self.inner_channel
        feat_channels = [pre_channel]
        downs = []
        for ind in range(num_mults):
            is_last = ind == num_mults - 1
            use_attn = now_res in self.attn_res
            channel_mult = self.inner_channel * self.channel_mults[ind]
            for _ in range(self.res_blocks):
                downs.append(('block', pre_channel, channel_mult, use_attn))
                feat_channels.append(channel_mult)
                pre_channel = channel_mult
            if not is_last:
                downs.append(('down', pre_channel, pre_channel, False))
                feat_channels.append(pre_channel)
                now_res //= 2
        mid_channel = pre_channel
        ups = []
        for ind in reversed(range(num_mults)):
            is_last = ind < 1
            use_attn = now_res in self.attn_res
            channel_mult = self.inner_channel * self.channel_mults[ind]
            for _ in range(self.res_blocks + 1):
                ups.append(('block', pre_channel + feat_channels.pop(),
                            channel_mult, use_attn))
                pre_channel = channel_mult
            if not is_last:
                ups.append(('up', pre_channel, pre_channel, False))
                now_res *= 2
        return downs, mid_channel, ups, pre_channel

    def guide_block_scales(self):
        """Ordered (name, block, downscale factor) for every AKGM block."""
        out = []
        s = 1
        for i, layer in enumerate(self.downs):
            if isinstance(layer, Downsample):
                s *= 2
            elif isinstance(layer, ResnetBlocWithAttn):
                out.append((f'downs.{i}', layer, s))
        out += [(f'mid.{i}', layer, s) for i, layer in enumerate(self.mid)]
        for i, layer in enumerate(self.ups):
            if isinstance(layer, Upsample):
                s //= 2
            else:
                out.append((f'ups.{i}', layer, s))
        return out

    def naiveforward(self, x, noise_level, guide, guide_maps=None,
                     dropout_generator=None):
        """x (B, H, W, in_channel) with H, W multiples of 32; guide_maps:
        optional {block name: maps} from compute_guide_maps. In train() mode
        the head's dropout draws its mask from `dropout_generator` (a
        torch.Generator on x's device; None: the global generator)."""
        gm = guide_maps or {}
        t = self.noise_level_mlp(noise_level)

        x, xs = self.downs[0](x, emit_stats=True)
        xs = totals(xs)
        feats = [(x, xs)]
        for i, layer in enumerate(self.downs[1:], start=1):
            if isinstance(layer, Downsample):
                x, xs = layer(x, emit_stats=True)
                xs = totals(xs)
            else:
                x, xs = layer(x, t, guide, gm.get(f'downs.{i}'), xs)
            feats.append((x, xs))
        for i, layer in enumerate(self.mid):
            x, xs = layer(x, t, guide, gm.get(f'mid.{i}'), xs)
        for i, layer in enumerate(self.ups):
            if isinstance(layer, Upsample):
                x, xs = layer(x, emit_stats=True)
                xs = totals(xs)
            else:
                skip, ss = feats.pop()
                x, xs = layer(torch.cat([x, skip], dim=-1), t, guide,
                              gm.get(f'ups.{i}'), _cat_stats(xs, ss))

        # head: GroupNorm -> swish -> dropout -> conv3x3. Without dropout it
        # is one pre-activated conv (K7): neither the normalized nor the
        # activated tensor is written. Dropout in between forces K2 on the
        # activated tensor.
        norm, _, drop, conv = self.final_conv
        a, t_ = norm1_affine_f32(x, norm.weight, norm.bias, xs)
        if drop.p == 0:
            return conv3x3_preact(x, conv.kernel_weight(), conv.bias,
                                  a.to(x.dtype), t_.to(x.dtype))
        x = swish(group_norm1(x, a, t_))
        if self.training and drop.p > 0:
            x = x * dropout_mask(x, drop.p, dropout_generator)
        return conv(x.contiguous())

    def forward(self, x, noise_level, guide, guide_maps=None,
                dropout_generator=None):
        """Pad-to-/32 wrapper (ucdir.py:295-307). guide_maps, if given, come
        from the /32-padded guide."""
        x, pads = pad_to_multiple(x, 32)
        guide, _ = pad_to_multiple(guide, 32)
        return crop_pad(self.naiveforward(x, noise_level, guide, guide_maps,
                                          dropout_generator), pads)


def compute_guide_maps(module: DY3h, guide):
    """Every AKGM block's guide-attention maps for a fixed guide, computed
    once per reverse process (the guide is step-invariant).
    guide: (B, H, W, 3), the /32-padded network input size.
    Returns {block name: (B, H // s, W // s, nset)}."""
    B, H, W, _ = guide.shape
    per_scale, maps = {}, {}
    for name, layer, s in module.guide_block_scales():
        if s not in per_scale:
            per_scale[s] = guide if s == 1 else F.interpolate(
                guide.permute(0, 3, 1, 2), size=(H // s, W // s),
                mode='bilinear', align_corners=False,
                antialias=False).permute(0, 2, 3, 1)
        maps[name] = guide_maps(layer.res_block, per_scale[s],
                                     (H // s, W // s))
    return maps
