"""The AKGM block tail: kernel K1 (`csrc/akgm_tail.cu`), its backward kernel
K5 (`csrc/akgm_tail_bwd.cu`), the mix alone K8 (`csrc/akgm_tail.cu`), the
group-packed tail K9 (`csrc/akgm_packed.cu`) and their plain versions.
Counterpart of `ucdir_tpu/ops/akgm.py` and `ucdir_tpu/ops/akgm_pallas.py`.

    hset = grouped_conv3x3(h * a + t) + bias   # (B, H, W, C * G), groups = G
    out  = swish(sum_j hset[..., c * G + j] * att[..., j] * attw[j]) + res

Conv output o = c * G + j belongs to group o // C, so all G candidates of
channel c read input group c // (C / G) (the reference's `.view(b, C, G, H,
W)` of the grouped conv). The kernel-layout weights are the grouped HWIO
kernel (3, 3, C / G, C * G) reshaped to (9 * C / G, C * G).

K1 and its backward K5 also take bfloat16 operands, all of one dtype, and
return bfloat16 (K1's statistics float32): the TPU kernels' bf16
instantiation, with their roundings (`akgm_block_tail_plain`,
`akgm_block_tail_backward_plain`). K8 and K9 take float32.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ucdir_tpu_torch.ops import _build
from ucdir_tpu_torch.ops.conv import (affine_grads, dswish, rounded,
                                     staged_affine, swish, tc_merge,
                                     vjp_of_plain, wgrad_workspace)
from ucdir_tpu_torch.ops.stats import fold_stats_grad, gn1_stats_plain


def akgm_mix_reference(h, att_sp, w, bias, nset: int):
    """Materializes the (B, H, W, C, G) candidates, as the reference does.
    h (B, H, W, C); att_sp (B, H, W, G); w (9 * C / G, C * G); bias (C * G)."""
    B, H, W, C = h.shape
    cg = C // nset
    k = w.reshape(3, 3, cg, C * nset).permute(3, 2, 0, 1)
    hset = F.conv2d(h.permute(0, 3, 1, 2), k, bias, padding=1, groups=nset)
    hset = hset.permute(0, 2, 3, 1).reshape(B, H, W, C, nset)
    return torch.einsum('bhwcj,bhwj->bhwc', hset, att_sp)


def akgm_block_tail_plain(h, att_sp, w, bias, res, nset: int, *,
                          norm_scale=None, norm_shift=None, attw=None,
                          emit_stats=False):
    """The plain version of K1 (`_block_ref` of
    ucdir_tpu/ops/akgm_pallas.py). bfloat16: as B1 computes in bf16
    (`_akgm_block_kernel_padfree`), on the operands' values in float32: the
    affine as `staged_affine`, att * attw rounded, each candidate z = conv +
    bias rounded, z * att rounded, the G terms added, swish and the residual
    in float32, the output rounded once."""
    if h.dtype == torch.bfloat16:
        dt = h.dtype
        B, H, W, C = h.shape
        hs = (h.float() if norm_scale is None
              else staged_affine(h, norm_scale, norm_shift))
        A = att_sp.float()
        if attw is not None:
            A = rounded(A * attw.float()[:, None, None, :], dt)
        k = w.float().reshape(3, 3, C // nset, C * nset).permute(3, 2, 0, 1)
        z = F.conv2d(hs.permute(0, 3, 1, 2), k, bias.float(), padding=1,
                     groups=nset)
        z = rounded(z.permute(0, 2, 3, 1).reshape(B, H, W, C, nset), dt)
        y = rounded(z * A[:, :, :, None, :], dt).sum(dim=-1)
        out = (swish(y) + res.float()).to(dt)
        return (out, gn1_stats_plain(out)) if emit_stats else out
    if norm_scale is not None:
        h = h * norm_scale[:, None, None, :] + norm_shift[:, None, None, :]
    if attw is not None:
        att_sp = att_sp * attw[:, None, None, :]
    y = akgm_mix_reference(h, att_sp, w, bias, nset)
    out = swish(y) + res
    return (out, gn1_stats_plain(out)) if emit_stats else out


def _akgm_block_tail_forward(h, att_sp, w, bias, res, nset, norm_scale,
                             norm_shift, attw, emit_stats):
    """(out, sum, sumsq), the last two None without emit_stats: K1 on a CUDA
    tensor, its plain version on a CPU tensor."""
    if _build.on_host(h):
        y = akgm_block_tail_plain(
            h, att_sp, w, bias, res, nset, norm_scale=norm_scale,
            norm_shift=norm_shift, attw=attw, emit_stats=emit_stats)
        return (y[0], *y[1]) if emit_stats else (y, None, None)
    B, H, W, C = h.shape
    kernel = _build.entry('akgm_tail', h)
    dev = _check_operands('K1', h, att_sp, w, bias, nset, norm_scale,
                          norm_shift, attw, dtype=h.dtype)
    _build.check('res', res, (B, H, W, C), device=dev, dtype=h.dtype)
    out = torch.empty_like(h)
    # the FMA core (float32) takes the columns permuted within each tile and
    # sums per tile of `tail_tile`; the tensor cores (bf16) the natural
    # columns with narrow groups merged, and sum per 8 x 16 pixel tile
    tc = h.dtype == torch.bfloat16
    wp = (tc_merged_weights(w, nset, k1_tc_merge(C, nset)).contiguous() if tc
          else permuted_columns(w))
    s = q = ws = None
    if emit_stats:
        s = torch.empty(B, C, device=dev, dtype=torch.float32)
        q = torch.empty_like(s)
        tiles = tc_pixel_tiles(H, W) if tc else stats_tiles(H * W, C)
        ws = torch.empty(B, tiles, 2, C, device=dev, dtype=torch.float32)
    _build.launch(kernel, h.data_ptr(), att_sp.data_ptr(),
                  _build.ptr(attw), wp.data_ptr(), bias.data_ptr(),
                  res.data_ptr(), _build.ptr(norm_scale),
                  _build.ptr(norm_shift), out.data_ptr(), _build.ptr(s),
                  _build.ptr(q), _build.ptr(ws), B, H, W, C,
                  _build.stream(h))
    return out, s, q


def _check_operands(kernel, h, att_sp, w, bias, nset, norm_scale, norm_shift,
                    attw, dtype=torch.float32):
    """Raises on what AKGM kernel `kernel` ('K1', 'K5', 'K8' or 'K9') does
    not take; w is the grouped kernel (9 * C / G, C * G), for K9 the dense
    (9 * C, C); every operand of `dtype`."""
    B, H, W, C = h.shape
    if nset != 8:
        raise ValueError('%s needs nset == 8, got nset=%d' % (kernel, nset))
    if C % 8:
        raise ValueError('%s needs C %% 8 == 0, got C=%d' % (kernel, C))
    dev = h.device
    _build.check('h', h, dtype=dtype)
    _build.check('att_sp', att_sp, (B, H, W, nset), device=dev, dtype=dtype)
    _build.check('w', w, (9 * C, C) if kernel == 'K9'
                 else (9 * C // nset, C * nset), device=dev, dtype=dtype)
    _build.check('bias', bias, (C * nset,), device=dev, dtype=dtype)
    _build.check('norm_scale', norm_scale, (B, C), device=dev, dtype=dtype)
    _build.check('norm_shift', norm_shift, (B, C), device=dev, dtype=dtype)
    _build.check('attw', attw, (B, nset), device=dev, dtype=dtype)
    return dev


def akgm_block_tail_backward_plain(h, att_sp, w, bias, go, nset: int, *,
                                   norm_scale=None, norm_shift=None,
                                   attw=None):
    """The plain version of K5: (dhh, datt_sp, dw, dbias, dattw) of the block
    tail for the output cotangent `go`, dhh the gradient of the affine's
    output h * a + t and dattw None without attw. It materializes the
    (B, H, W, C, G) candidates and their gradient, which K5 never writes.

    bfloat16: as B8 computes in bf16 (`_akgm_block_bwd_kernel` of
    ucdir_tpu/ops/akgm_pallas.py), on the operands' values in float32: the
    affine as `staged_affine`; A = att * attw in float32 (exact); z
    recomputed in float32, then m = z * A of z and A each rounded, itself
    rounded, and o the float32 sum of the G terms; do = go * swish'(o)
    rounded once; dz = do * A, rounded where the weight and the input
    gradient read it, and dbias the float32 sum of the unrounded dz; the
    datt terms do * z rounded before their float32 sum over the channels;
    every gradient rounded once at the end."""
    B, H, W, C = h.shape
    cg = C // nset
    low = h.dtype if h.dtype == torch.bfloat16 else None
    if low is not None:
        h = (h.float() if norm_scale is None
             else staged_affine(h, norm_scale, norm_shift))
        att_sp, w, bias, go = att_sp.float(), w.float(), bias.float(), \
            go.float()
        attw = None if attw is None else attw.float()
    elif norm_scale is not None:
        h = h * norm_scale[:, None, None, :] + norm_shift[:, None, None, :]
    A = att_sp if attw is None else att_sp * attw[:, None, None, :]
    k = w.reshape(3, 3, cg, C * nset).permute(3, 2, 0, 1)
    hn = h.permute(0, 3, 1, 2)
    z = F.conv2d(hn, k, bias, padding=1, groups=nset)      # (B, C * G, H, W)
    z5 = z.permute(0, 2, 3, 1).reshape(B, H, W, C, nset)
    if low is None:
        o = torch.einsum('bhwcj,bhwj->bhwc', z5, A)
        do = go * dswish(o)
    else:
        m = rounded(rounded(z5, low) * rounded(A, low)[:, :, :, None, :],
                    low)
        do = rounded(go * dswish(m.sum(dim=-1)), low)
    dz = (do[..., None] * A[:, :, :, None, :]).reshape(B, H, W, C * nset)
    dz = dz.permute(0, 3, 1, 2)
    dzr = dz if low is None else rounded(dz, low)
    dhh = F.conv_transpose2d(dzr, k, padding=1, groups=nset)
    dk = torch.nn.grad.conv2d_weight(hn, k.shape, dzr, padding=1,
                                     groups=nset)
    dw = dk.permute(2, 3, 1, 0).reshape(9 * cg, C * nset)
    if low is None:
        q = torch.einsum('bhwc,bhwcj->bhwj', do, z5)
    else:
        q = rounded(do[..., None] * z5, low).sum(dim=-2)
    datt = q if attw is None else q * attw[:, None, None, :]
    dattw = None if attw is None else (q * att_sp).sum(dim=(1, 2))
    grads = (dhh.permute(0, 2, 3, 1).contiguous(), datt, dw,
             dz.sum(dim=(0, 2, 3)), dattw)
    if low is None:
        return grads
    return tuple(None if g is None else g.to(low) for g in grads)


def tail_tile(C):
    """(pixels, columns) of the tile of K1's and K8's product
    (`csrc/akgm_tail.cu`) and of K5's z recompute (`csrc/akgm_tail_bwd.cu`):
    128 x 128 where C % 128 == 0, 256 x 64 where C % 64 == 0, else 128
    pixels by the widest of 32, 16 and 8 columns that divides C, so that a
    tile lies in one group."""
    if C % 128 == 0:
        return 128, 128
    if C % 64 == 0:
        return 256, 64
    return 128, next(bn for bn in (32, 16, 8) if C % bn == 0)


def stats_tiles(P, C):
    """Pixel tiles of an image of P pixels in K1's float32 product: the rows
    of its (B, tiles, 2, C) statistics workspace, one partial sum and sum of
    squares per tile and channel, and of K5's float32 (B, tiles, G)
    workspace of dattw."""
    return -(-P // tail_tile(C)[0])


def tile_columns(n, bn):
    """The logical column that each physical column of K1's, K8's and K5's
    grouped product holds, (n,) int64: in a tile of `bn` columns a consumer
    thread holds the physical columns 4 i + r and bn / 2 + 4 i + r (r < 4;
    igemm_pc.cuh), and they must be channel i's candidates 0..7, logical
    8 i + 4 h + r."""
    p = torch.arange(n)
    tile, r = p // bn, p % bn
    half, rest = r // (bn // 2), r % (bn // 2)
    return tile * bn + (rest // 4) * 8 + half * 4 + rest % 4


@functools.lru_cache(maxsize=None)
def _tile_columns_on(n, bn, device):
    return tile_columns(n, bn).to(device)


def permuted_columns(w):
    """The grouped kernel (9 * C / G, C * G) with its columns permuted within
    each tile of `tail_tile`, as the grouped product's kernels take it: a
    gather per call, since the weights change in training."""
    n = w.shape[1]
    return w[:, _tile_columns_on(n, tail_tile(n // 8)[1],
                                 w.device)].contiguous()


def tc_pixel_tiles(H, W):
    """Pixel tiles of an H x W image on the tensor cores (`csrc/igemm_tc.cuh`:
    8 x 16 output pixels), the rows of K1's bf16 (B, tiles, 2, C) workspace
    of statistics and of K5's bf16 (B, tiles, G) workspace of dattw."""
    return -(-H // 8) * -(-W // 16)


def k1_tc_merge(C, nset: int = 8):
    """The groups K1's bf16 product merges into one (`csrc/akgm_tail.cu`
    tail_tc): `conv.tc_merge`'s, then doubled (up to nset) while a merged
    group is narrower than the product's 128-column tile."""
    m = tc_merge(C // nset)
    while m * C < 128 and m < nset:
        m *= 2
    return m


def tc_merged_weights(w, nset: int, m=None):
    """The weights (9 * C / G, C * G) of K1's bf16 product and K5's z
    recompute on the tensor cores, in natural column order: where a group's
    C / G channels are no multiple of 8, `conv.tc_merge` m groups become one
    of m * C / G channels with block-diagonal weights (9 * m * C / G, C *
    G): row tap * m cg + u cg + ci, column g C + c, nonzero where g % m ==
    u. Unchanged where m is 1. m: `tc_merge`'s unless given (K1's
    `k1_tc_merge`)."""
    cg = w.shape[0] // 9
    C = w.shape[1] // nset
    m = tc_merge(cg) if m is None else m
    if m == 1:
        return w
    wm = w.new_zeros(9 * m * cg * nset * C)
    wm.index_copy_(0, _merge_index(cg, C, nset, m, w.device), w.reshape(-1))
    return wm.reshape(9 * m * cg, nset * C)


@functools.lru_cache(maxsize=None)
def _merge_index(cg, C, nset, m, device):
    """Where each element of the grouped weights (9 * cg, nset * C), in
    row-major order, lies in the merged (9, m, cg, nset, C): (tap, g % m,
    ci, g, c), flat."""
    tap, ci, g, c = torch.meshgrid(torch.arange(9), torch.arange(cg),
                                   torch.arange(nset), torch.arange(C),
                                   indexing='ij')
    return ((((tap * m + g % m) * cg + ci) * nset + g) * C + c).reshape(
        -1).to(device)


def akgm_block_tail_backward_kernel(h, att_sp, w, bias, go, nset,
                                     norm_scale, norm_shift, attw):
    """K5 on CUDA tensors, every operand float32 or every one bfloat16:
    (dhh, datt_sp, dw, dbias, dattw) of that dtype."""
    B, H, W, C = h.shape
    dt = h.dtype
    kernel = _build.entry('akgm_tail_bwd', h)
    dev = _check_operands('K5', h, att_sp, w, bias, nset, norm_scale,
                          norm_shift, attw, dtype=dt)
    _build.check('go', go, (B, H, W, C), device=dev, dtype=dt)
    cg = C // nset
    # per-group weights of the transposed conv: (G, 9 * C, C / G), taps
    # flipped, wf[g][tap * C + n][ci] = w[(8 - tap) * C/G + ci][g * C + n]
    wf = (w.reshape(9, cg, nset, C).flip(0).permute(2, 0, 3, 1).contiguous())
    # the z recompute's weights and bias: on the FMA core (float32) the
    # columns permuted within each tile; on the tensor cores (bf16) as they
    # are (a channel's 8 candidates are one 8-column slab of wgmma's
    # accumulator), narrow groups merged (`tc_merged_weights`)
    tc = dt == torch.bfloat16
    if tc:
        wp, bp = tc_merged_weights(w, nset).contiguous(), bias
    else:
        cols = _tile_columns_on(C * nset, tail_tile(C)[1], w.device)
        wp, bp = w[:, cols].contiguous(), bias[cols].contiguous()
    do = torch.empty_like(h)             # scratch: go * swish'(o)
    # scratch: att * attw in float32 (in bf16 also without attw)
    aa = (None if attw is None and dt == torch.float32 else
          torch.empty(att_sp.shape, device=dev, dtype=torch.float32))
    dhh = torch.empty_like(h)
    datt = torch.empty_like(att_sp)
    dw = torch.empty_like(w)
    dbias = torch.empty_like(bias)
    dattw = wsa = None
    if attw is not None:
        dattw = torch.empty_like(attw)
        # per pixel tile sums of dattw, added in a fixed order
        tiles = (tc_pixel_tiles(H, W) if tc
                 else stats_tiles(H * W, C))
        wsa = torch.empty(B, tiles, nset, device=dev, dtype=torch.float32)
    splits, ws = wgrad_workspace(9 * cg, C * nset, C, B * H * W, dev,
                                 tensor_cores=tc)
    _build.launch(kernel, h.data_ptr(), go.data_ptr(),
                  att_sp.data_ptr(), _build.ptr(attw), wp.data_ptr(),
                  wf.data_ptr(), bp.data_ptr(), _build.ptr(norm_scale),
                  _build.ptr(norm_shift), do.data_ptr(), _build.ptr(aa),
                  dhh.data_ptr(), datt.data_ptr(), dw.data_ptr(),
                  dbias.data_ptr(), _build.ptr(dattw), ws.data_ptr(),
                  _build.ptr(wsa), B, H, W, C, splits, _build.stream(h))
    return dhh, datt, dw, dbias, dattw


def akgm_block_tail_backward(h, att_sp, w, bias, go, nset: int, *,
                             norm_scale=None, norm_shift=None, attw=None):
    """Every gradient of `akgm_block_tail` for the output cotangent `go`:
    (dh, datt_sp, dw, dbias, dres, dnorm_scale, dnorm_shift, dattw), None for
    an absent optional. K5 on CUDA tensors, its plain version on the CPU;
    the affine's own gradients are plain tensor ops on either."""
    if _build.on_host(h):
        dhh, datt, dw, dbias, dattw = akgm_block_tail_backward_plain(
            h, att_sp, w, bias, go, nset, norm_scale=norm_scale,
            norm_shift=norm_shift, attw=attw)
    else:
        go = go.contiguous()
        dhh, datt, dw, dbias, dattw = akgm_block_tail_backward_kernel(
            h, att_sp, w, bias, go, nset, norm_scale, norm_shift, attw)
    if norm_scale is None:
        return dhh, datt, dw, dbias, go, None, None, dattw
    dh, dns, dnt = affine_grads(dhh, h, norm_scale, norm_shift)
    return dh, datt, dw, dbias, go, dns, dnt, dattw


class _AkgmBlockTail(torch.autograd.Function):
    """Forward K1. Backward: the statistics' cotangents fold into the
    output's, then K5."""

    @staticmethod
    def forward(ctx, h, att_sp, w, bias, res, norm_scale, norm_shift, attw,
                nset, emit_stats):
        ctx.set_materialize_grads(False)
        out, s, q = _akgm_block_tail_forward(
            h, att_sp, w, bias, res, nset, norm_scale, norm_shift, attw,
            emit_stats)
        ctx.save_for_backward(h, att_sp, w, bias, norm_scale, norm_shift,
                              attw, out if emit_stats else None)
        ctx.conf = (nset, emit_stats)
        return (out, s, q) if emit_stats else out

    @staticmethod
    def backward(ctx, g, ds=None, dq=None):
        h, att_sp, w, bias, ns, nt, attw, out = ctx.saved_tensors
        nset, emit_stats = ctx.conf
        if emit_stats:
            g = fold_stats_grad(g, out, ds, dq)
        dh, datt, dw, dbias, dres, dns, dnt, dattw = akgm_block_tail_backward(
            h, att_sp, w, bias, g, nset, norm_scale=ns, norm_shift=nt,
            attw=attw)
        return dh, datt, dw, dbias, dres, dns, dnt, dattw, None, None


def akgm_block_tail(h, att_sp, w, bias, res, nset: int, *, norm_scale=None,
                    norm_shift=None, attw=None, emit_stats=False):
    """`swish(akgm_mix(h * a + t, att * attw)) + res` as one pass,
    differentiable in every tensor operand.

    h, res (B, H, W, C); att_sp (B, H, W, G); w (9 * C / G, C * G); bias
    (C * G); norm_scale, norm_shift (B, C) or None; attw (B, G) or None.
    With emit_stats, returns (out, (sum, sumsq)) of out per (batch, channel).
    The kernels take G = 8 and C a multiple of 8, forward (K1) and backward
    (K5).
    """
    if (norm_scale is None) != (norm_shift is None):
        raise ValueError('norm_scale and norm_shift come together')
    y = _AkgmBlockTail.apply(h, att_sp, w, bias, res, norm_scale, norm_shift,
                             attw, nset, emit_stats)
    return (y[0], (y[1], y[2])) if emit_stats else y


class _AkgmMix(torch.autograd.Function):
    """Forward K8; the backward is the autograd of `akgm_mix_reference`, as
    in the JAX package (`akgm_mix_pallas`), which owes no kernel here."""

    @staticmethod
    def forward(ctx, h, att_sp, w, bias, nset):
        ctx.save_for_backward(h, att_sp, w, bias)
        ctx.nset = nset
        if _build.on_host(h):
            return akgm_mix_reference(h, att_sp, w, bias, nset)
        B, H, W, C = h.shape
        _check_operands('K8', h, att_sp, w, bias, nset, None, None, None)
        wp, out = permuted_columns(w), torch.empty_like(h)
        _build.launch('akgm_mix', h.data_ptr(), att_sp.data_ptr(),
                      wp.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H,
                      W, C, _build.stream(h))
        return out

    @staticmethod
    def backward(ctx, g):
        nset = ctx.nset
        return (*vjp_of_plain(
            lambda h, a, w, b: akgm_mix_reference(h, a, w, b, nset),
            ctx.saved_tensors, (g,)), None)


def akgm_mix(h, att_sp, w, bias, nset: int):
    """`sum_j (grouped_conv3x3(h) + bias)[..., c * G + j] * att_sp[..., j]`:
    the candidates mixed per pixel, without ever writing them. No fold, no
    mixing weights, no activation, no residual; differentiable in every
    operand. Operands as `akgm_block_tail`'s."""
    return _AkgmMix.apply(h, att_sp, w, bias, nset)


def pack_grouped_weight(w, nset: int):
    """The grouped kernel (9 * C / G, C * G) as the packed tail's dense
    (9 * C, C) matrix: row tap * C + j * (C / G) + cg, column i, value
    w[tap * (C / G) + cg, i * G + j] (`_pack_grouped_kernel` of
    ucdir_tpu/ops/akgm_pallas.py)."""
    cg = w.shape[0] // 9
    C = cg * nset
    return w.reshape(9, cg, C, nset).permute(0, 3, 1, 2).reshape(9 * C, C)


def akgm_block_tail_packed_plain(h, att_sp, w_packed, bias, res, nset: int, *,
                                 norm_scale=None, norm_shift=None, attw=None):
    """The plain version of K9: with A = att_sp * attw and hh = h * a + t,

        out[p, i] = swish(sum_j A[p, j] * (conv3x3(hh[group j], k_j)[p, i]
                                           + bias[i * G + j])) + res[p, i]

    k_j (3, 3, C / G, C) being rows tap * C + j * (C / G) + cg of w_packed.
    The output pixel's attention scales input group j against candidate j of
    every output channel."""
    B, H, W, C = h.shape
    cg = C // nset
    if norm_scale is not None:
        h = h * norm_scale[:, None, None, :] + norm_shift[:, None, None, :]
    A = att_sp if attw is None else att_sp * attw[:, None, None, :]
    # one grouped conv: group j's input against its (C / G) -> C kernel
    k = w_packed.reshape(3, 3, nset, cg, C).permute(2, 4, 3, 0, 1)
    y = F.conv2d(h.permute(0, 3, 1, 2), k.reshape(nset * C, cg, 3, 3), None,
                 padding=1, groups=nset)
    y = y.permute(0, 2, 3, 1).reshape(B, H, W, nset, C)
    y = torch.einsum('bhwjc,bhwj->bhwc', y, A) + A @ bias.reshape(C, nset).t()
    return swish(y) + res


class _AkgmBlockTailPacked(torch.autograd.Function):
    """Forward K9; the backward is the autograd of the plain version (the
    JAX package gives this form no gradient of its own)."""

    @staticmethod
    def forward(ctx, h, att_sp, w_packed, bias, res, norm_scale, norm_shift,
                attw, nset):
        ctx.save_for_backward(h, att_sp, w_packed, bias, res, norm_scale,
                              norm_shift, attw)
        ctx.nset = nset
        if _build.on_host(h):
            return akgm_block_tail_packed_plain(
                h, att_sp, w_packed, bias, res, nset, norm_scale=norm_scale,
                norm_shift=norm_shift, attw=attw)
        B, H, W, C = h.shape
        dev = _check_operands('K9', h, att_sp, w_packed, bias, nset,
                              norm_scale, norm_shift, attw)
        _build.check('res', res, (B, H, W, C), device=dev)
        out = torch.empty_like(h)
        _build.launch('akgm_packed', h.data_ptr(), att_sp.data_ptr(),
                      _build.ptr(attw), w_packed.data_ptr(), bias.data_ptr(),
                      res.data_ptr(), _build.ptr(norm_scale),
                      _build.ptr(norm_shift), out.data_ptr(), B, H, W, C,
                      _build.stream(h))
        return out

    @staticmethod
    def backward(ctx, g):
        nset = ctx.nset
        return (*vjp_of_plain(
            lambda h, a, w, b, r, ns, nt, aw: akgm_block_tail_packed_plain(
                h, a, w, b, r, nset, norm_scale=ns, norm_shift=nt, attw=aw),
            ctx.saved_tensors, (g,)), None)


def akgm_block_tail_packed(h, att_sp, w_packed, bias, res, nset: int, *,
                           norm_scale=None, norm_shift=None, attw=None):
    """The group-packed block tail: the attention scales the input channels
    by their group and one dense (9 * C) -> C product follows, then the
    attention-weighted bias, swish and the residual. w_packed (9 * C, C) from
    `pack_grouped_weight`; the other operands as `akgm_block_tail`'s. No
    statistics.

    This form computes a DIFFERENT pairing than the reference network: here
    candidate j of every output channel reads input group j, while the
    reference (`akgm_block_tail`) lets all G candidates of output channel i
    read the one input group i // (C / G) (ucdir_tpu/ops/DISPATCH.md, the
    packing study). It does not reproduce the trained model's outputs and is
    kept so that the study's question stays answerable on both packages."""
    if (norm_scale is None) != (norm_shift is None):
        raise ValueError('norm_scale and norm_shift come together')
    return _AkgmBlockTailPacked.apply(h, att_sp, w_packed, bias, res,
                                      norm_scale, norm_shift, attw, nset)
