"""Spatial self-attention on NHWC tensors, in plain PyTorch (float32 matmuls
and softmax). Counterpart of `ucdir_tpu/models/attention.py`, which has no
Pallas kernel (reference: model/ucdir.py:155-182).

In bfloat16, as the JAX package: the scores and the softmax in float32 (q and
k upcast, their products exact), the probabilities rounded to bfloat16, the
PV product accumulated in float32 and its output rounded to bfloat16; the
projections in bfloat16. Its backward (training) saves the bfloat16 q, k
and v and recomputes the scores.

The scale is 1 / sqrt(C), the full channel count, as in the reference.
Above `_STREAM_TOKENS` tokens the softmax runs over query chunks of `_CHUNK`
(the same math in O(N * chunk) memory); above `_WINDOW_TOKENS` tokens it runs
independently inside windows — row bands of at most `_WINDOW_TOKENS` tokens
when there is one head, near-square windows of about `_WINDOW_TARGET` tokens
per axis otherwise — the scope a reference 1024 px patch gives attention.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ucdir_tpu_torch.models.akgm import norm1_affine_f32
from ucdir_tpu_torch.models.layers import group_norm, group_norm1
from ucdir_tpu_torch.ops.gn_scope import tile_gn

_STREAM_TOKENS = 4096
_CHUNK = 1024
_WINDOW_TOKENS = 16384
_WINDOW_TARGET = 144


def _dense_attention(q, k, v, scale):
    """softmax(q k^T * scale) v for (b, n_head, N, d) operands."""
    if q.dtype != torch.float32:
        return _LowAttention.apply(q, k, v, scale)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)


def _low_forward(q, k, v, scale):
    """(the output, the float32 probabilities p) of `_dense_attention` on
    low-precision operands."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype), p


class _LowAttention(torch.autograd.Function):
    """`_dense_attention` of bfloat16 operands with the gradients of its
    composition (the upcasts, the float32 scores and softmax, the
    probabilities rounded, the float32 PV product rounded; each upcast's
    gradient rounded back): it saves q, k and v as they are and recomputes
    the scores in backward, never keeping a float32 copy alive."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _low_forward(q, k, v, scale)[0]

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale, dt = ctx.scale, q.dtype
        _, p = _low_forward(q, k, v, scale)
        g = g.float()
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g).to(dt)
        dp = torch.matmul(g, v.float().transpose(-1, -2)).to(dt).float()
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
        dq = torch.matmul(ds, k.float()).to(dt)
        dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(dt)
        return dq, dk, dv, None


def _streaming_attention(q, k, v, scale):
    """_dense_attention over query chunks of _CHUNK rows."""
    kt, vf = k.float().transpose(-1, -2), v.float()
    out = []
    for qi in torch.split(q, _CHUNK, dim=2):
        s = torch.matmul(qi.float(), kt) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        num = torch.matmul(p.to(v.dtype).float(), vf)
        out.append((num / p.sum(dim=-1, keepdim=True)).to(q.dtype))
    return torch.cat(out, dim=2)


def _attend(q, k, v, scale):
    if q.shape[2] > _STREAM_TOKENS:
        return _streaming_attention(q, k, v, scale)
    return _dense_attention(q, k, v, scale)


def _window_split(n: int, target: int) -> int:
    """Smallest window count dividing n with windows of <= target rows."""
    for kk in range(1, n + 1):
        if n % kk == 0 and n // kk <= target:
            return kk
    return n


def _windowed_attention(q, k, v, scale, wy: int, wx: int):
    """Independent attention per (h / wy, w / wx) window of (b, h, w, n_head,
    d) operands; returns the same layout."""
    b, h, w, nh, d = q.shape
    hw, ww = h // wy, w // wx

    def to_win(a):
        a = a.reshape(b, wy, hw, wx, ww, nh, d).permute(0, 1, 3, 5, 2, 4, 6)
        return a.reshape(b * wy * wx, nh, hw * ww, d)

    o = _attend(to_win(q), to_win(k), to_win(v), scale)
    o = o.reshape(b, wy, wx, nh, hw, ww, d).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, h, w, nh, d)


class SelfAttention(nn.Module):
    def __init__(self, in_channel: int, n_head: int = 1,
                 norm_groups: int = 1):
        super().__init__()
        self.n_head = n_head
        self.norm = nn.GroupNorm(norm_groups, in_channel)
        self.qkv = nn.Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, x, gn_win=None):
        """x (B, H, W, C) NHWC -> x + out(attention(norm(x))); gn_win: the
        GroupNorm(1) window of UCDIR_TPU_GN_SCOPE=tile or None."""
        b, h, w, c = x.shape
        nh, hd = self.n_head, c // self.n_head
        # one K4 pass and an affine: PyTorch's group_norm reduces each
        # (batch, group) in one thread block, one block for GroupNorm(1)
        if self.norm.num_groups == 1 and gn_win is not None:
            norm = tile_gn(x, self.norm.weight, self.norm.bias, gn_win)
        elif self.norm.num_groups == 1:
            norm = group_norm1(x, *norm1_affine_f32(x, self.norm.weight,
                                                    self.norm.bias))
        else:
            norm = group_norm(x, self.norm)
        norm = norm.reshape(-1, c)
        qkv = torch.matmul(norm, self.qkv.weight.reshape(3 * c, c).t())
        # channels are (n_head, 3 * head_dim), chunked into q, k, v
        qkv = qkv.reshape(b, h, w, nh, 3 * hd)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        scale = 1.0 / math.sqrt(c)
        if h * w > _WINDOW_TOKENS:
            if nh == 1 and w <= _WINDOW_TOKENS:
                # row bands: with one head the split is a pure reshape
                wy = next(kk for kk in range(1, h + 1)
                          if h % kk == 0 and (h // kk) * w <= _WINDOW_TOKENS)
                wx = 1
            else:
                wy = _window_split(h, _WINDOW_TARGET)
                wx = _window_split(w, _WINDOW_TARGET)
            o = _windowed_attention(q, k, v, scale, wy, wx)
        else:
            def heads(a):
                return a.reshape(b, h * w, nh, hd).transpose(1, 2)
            o = _attend(heads(q), heads(k), heads(v), scale)
            o = o.transpose(1, 2)
        o = o.reshape(-1, c)
        out = (torch.matmul(o, self.out.weight.reshape(c, c).t())
               + self.out.bias)
        return out.reshape(b, h, w, c) + x
