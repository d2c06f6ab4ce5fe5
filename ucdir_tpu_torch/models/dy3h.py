"""DY3h — the guided diffusion denoiser UNet on NHWC tensors. Counterpart of
`ucdir_tpu/models/dy3h.py` (reference: model/ucdir.py:204-307).

The module tree and parameter names are the reference's (`downs.0`,
`downs.<i>.res_block.*`, `downs.<i>.attn.*`, `downs.<i>.conv.*`, `mid.*`,
`ups.*`, `noise_level_mlp.{1,3}`, `final_conv.{0,3}`), so a reference state
dict loads with `strict=True`.

`resname` picks the residual block: 'ResnetBlockDY3h' (AKGM, guided) or
'ResnetBlock' (SR3's, no guide: the guide is read by no block and
`compute_guide_maps` returns {}); `norm_groups` goes to every block's
GroupNorms and attention's.

GroupNorm(1) statistics are chained: every producer kernel (downs_0, each
AKGM block's tail at norm_groups 1, Down/Upsample) emits its output's
per-(batch, channel) sums, the next block's folded norm uses their totals,
and totals add across skip concats. Attention, a `ResnetBlock` and an AKGM
block at norm_groups > 1 void the chain; the next GroupNorm(1) (the head's)
then takes its statistics with kernel K4.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ucdir_tpu_torch.models.akgm import (ResnetBlockDY3h, guide_maps,
                                         norm1_affine_f32, totals)
from ucdir_tpu_torch.models.attention import SelfAttention
from ucdir_tpu_torch.models.layers import (Conv3, Downsample,
                                           PositionalEncoding, ResnetBlock,
                                           Upsample, crop_pad, dropout_mask,
                                           group_norm1, pad_to_multiple)
from ucdir_tpu_torch.ops.conv import conv3x3_preact, swish
from ucdir_tpu_torch.ops.gn_scope import SCOPES, gn_tile_window, tile_gn

RESNAMES = ('ResnetBlockDY3h', 'ResnetBlock')


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim: int, dim_out: int, nl_emb_dim: int,
                 norm_groups: int = 1, with_attn: bool = False,
                 tail: str = 'fused', resname: str = 'ResnetBlockDY3h',
                 dropout: float = 0.0):
        super().__init__()
        if resname == 'ResnetBlockDY3h':
            # the AKGM block has no dropout, as in the reference
            self.res_block = ResnetBlockDY3h(
                dim, dim_out, nl_emb_dim, norm_groups=norm_groups, tail=tail)
        else:
            self.res_block = ResnetBlock(dim, dim_out, nl_emb_dim,
                                         dropout=dropout,
                                         norm_groups=norm_groups)
        self.attn = (SelfAttention(dim_out, norm_groups=norm_groups)
                     if with_attn else None)

    def forward(self, x, time_emb, guide, g_maps=None, in_stats=None,
                dropout_generator=None, gn_win=None):
        if isinstance(self.res_block, ResnetBlock):
            x, xs = self.res_block(x, time_emb, dropout_generator,
                                   gn_win), None
        else:
            x, xs = self.res_block(x, time_emb, guide, g_maps, in_stats,
                                   gn_win)
        if self.attn is not None:
            x, xs = self.attn(x, gn_win), None
        return x, xs


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
                 tail: str = 'fused', resname: str = 'ResnetBlockDY3h',
                 gn_scope: str = 'canvas', gn_tile: int = 1024):
        """tail: how every AKGM block runs its tail, 'fused' | 'mix' |
        'packed' (models/akgm.py). dropout == 0 folds the head into one
        pre-activated conv (K7). resname: the residual block, one of
        RESNAMES. gn_scope, gn_tile: the statistics scope of every
        GroupNorm(1), 'canvas' or 'tile' with gn_tile-px canvas windows
        (ops/gn_scope.py)."""
        super().__init__()
        if resname not in RESNAMES:
            raise ValueError('resname must be one of %s, got %r'
                             % (RESNAMES, resname))
        if gn_scope not in SCOPES:
            raise ValueError('gn_scope must be one of %s, got %r'
                             % (SCOPES, gn_scope))
        self.resname = resname
        self.gn_scope, self.gn_tile = gn_scope, int(gn_tile)
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
                                      with_attn, tail, resname, dropout)

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
        """Ordered (name, block, downscale factor) for every residual block
        (each an AKGM block under resname 'ResnetBlockDY3h')."""
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
        the head's dropout and every `ResnetBlock`'s draw their masks, in
        the order of the layers, from `dropout_generator` (a torch.Generator
        on x's device, or a DataShard of one; None: the global
        generator)."""
        gm = guide_maps or {}
        t = self.noise_level_mlp(noise_level)
        # this call's input is the canvas of the tile-scoped GroupNorms
        canvas = x.shape[1:3]

        def win(a):
            if self.gn_scope != 'tile':
                return None
            return gn_tile_window(canvas, a.shape[1], a.shape[2],
                                  self.gn_tile)

        x, xs = self.downs[0](x, emit_stats=True)
        xs = totals(xs)
        feats = [(x, xs)]
        for i, layer in enumerate(self.downs[1:], start=1):
            if isinstance(layer, Downsample):
                x, xs = layer(x, emit_stats=True)
                xs = totals(xs)
            else:
                x, xs = layer(x, t, guide, gm.get(f'downs.{i}'), xs,
                              dropout_generator, win(x))
            feats.append((x, xs))
        for i, layer in enumerate(self.mid):
            x, xs = layer(x, t, guide, gm.get(f'mid.{i}'), xs,
                          dropout_generator, win(x))
        for i, layer in enumerate(self.ups):
            if isinstance(layer, Upsample):
                x, xs = layer(x, emit_stats=True)
                xs = totals(xs)
            else:
                skip, ss = feats.pop()
                x, xs = layer(torch.cat([x, skip], dim=-1), t, guide,
                              gm.get(f'ups.{i}'), _cat_stats(xs, ss),
                              dropout_generator, win(x))

        # head: GroupNorm -> swish -> dropout -> conv3x3. Without dropout it
        # is one pre-activated conv (K7): neither the normalized nor the
        # activated tensor is written. Dropout in between forces K2 on the
        # activated tensor.
        norm, _, drop, conv = self.final_conv
        if drop.p == 0 and win(x) is not None:
            # tile scope: normalize per window, then K7 with an identity
            # affine
            x = tile_gn(x, norm.weight, norm.bias, win(x))
            one = x.new_ones(x.shape[0], x.shape[-1])
            return conv3x3_preact(x, conv.kernel_weight(), conv.bias, one,
                                  torch.zeros_like(one))
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
    Returns {block name: (B, H // s, W // s, nset)}, {} for a network with
    no AKGM block (resname 'ResnetBlock')."""
    if module.resname != 'ResnetBlockDY3h':
        return {}
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
