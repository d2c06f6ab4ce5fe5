"""Tile-scoped GroupNorm(1) statistics for whole-image evaluation.
Counterpart of `ucdir_tpu/ops/gn_scope.py`.

The reference tiles every image above 1024^2 through the denoiser
(model/ucdir.py:295-300 under utils/util.py:108-146), so each GroupNorm(1)
inside the network takes its mean and variance over one ~1024-px tile. The
whole-image path takes them over the whole canvas. `UCDIR_TPU_GN_SCOPE=tile`
gives the reference's scope inside the seamless whole-image pass: every
GroupNorm(1) normalizes per window of its feature map, (GN_TILE / k)^2 with
k the map's downscale factor against the canvas, so a window is always one
GN_TILE-px canvas tile (`UCDIR_TPU_GN_TILE`, default 1024). Ragged edge
windows use their true pixel counts.

The switches are read once, by `define_G` (`gn_scope_from_env`), into the
DY3h's `gn_scope` and `gn_tile` attributes. `DY3h.naiveforward` records its
input's size as the canvas, and each norm site asks `gn_tile_window` for its
window. A map that fits within about 1.5 windows keeps the canvas scope,
where the two coincide, and with it the folded-norm kernels; so the tiled
path, whose canvas is one tile, runs its usual kernels with the switch set.

Default 'canvas': the folded path of the kernels. Under 'tile' an AKGM
block normalizes explicitly and runs K2 with swish and no fold, then K1 with
no fold; the head runs K7 with an identity affine.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

SCOPES = ('canvas', 'tile')


def gn_scope_from_env() -> Tuple[str, int]:
    """(scope, tile) from UCDIR_TPU_GN_SCOPE ('canvas' by default, or
    'tile') and UCDIR_TPU_GN_TILE (1024 by default)."""
    scope = os.environ.get('UCDIR_TPU_GN_SCOPE', 'canvas')
    if scope not in SCOPES:
        raise ValueError('UCDIR_TPU_GN_SCOPE=%r: expected one of %s'
                         % (scope, SCOPES))
    return scope, int(os.environ.get('UCDIR_TPU_GN_TILE', '1024'))


def gn_tile_window(canvas: Tuple[int, int], h: int, w: int,
                   tile: int = 1024) -> Optional[int]:
    """The window (feature-map pixels per axis) of a GroupNorm(1) on an
    h x w map of the canvas (H, W), or None where the canvas scope applies:
    the map fits within 1.5 windows, so the two scopes coincide."""
    k = max(1, round(canvas[0] / float(h)))
    win = max(1, tile // k)
    if h <= (win * 3) // 2 and w <= (win * 3) // 2:
        return None
    return win


def tile_gn(x, scale, bias, win: int, eps: float = 1e-5):
    """GroupNorm(num_groups=1) of NHWC x with statistics per win x win
    window: sums in float32 over (win, win, C), the ragged bottom and right
    windows over their true element counts, the variance E[x^2] - mean^2.
    scale, bias: (C,). Returns x's dtype."""
    B, H, W, C = x.shape
    ph, pw = (-H) % win, (-W) % win
    xf = x.float()
    if ph or pw:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pw, 0, ph))
    nH, nW = (H + ph) // win, (W + pw) // win
    xr = xf.reshape(B, nH, win, nW, win, C)
    s = xr.sum(dim=(2, 4, 5))                              # (B, nH, nW)
    q = (xr * xr).sum(dim=(2, 4, 5))
    rows = torch.clamp(H - torch.arange(nH, device=x.device) * win, max=win)
    cols = torch.clamp(W - torch.arange(nW, device=x.device) * win, max=win)
    cnt = (rows[:, None] * cols[None, :]).float() * C      # (nH, nW)
    mean = s / cnt
    var = q / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = (xr - mean[:, :, None, :, None, None]) \
        * rstd[:, :, None, :, None, None]
    y = y.reshape(B, H + ph, W + pw, C)[:, :H, :W]
    return (y * scale.float() + bias.float()).to(x.dtype)
