"""3x3 and 1x1 convolutions on NHWC tensors: kernels K2 (`csrc/conv3x3.cu`)
and K3 (`csrc/conv1x1.cu`), the 3x3 backward kernel K6
(`csrc/conv3x3_bwd.cu`), the pre-activated 3x3 conv K7 (`csrc/conv3x3.cu`),
their plain versions, and the phase-packed nearest-x2 upsampling conv built
on K2. Counterpart of
`ucdir_tpu/ops/conv_pallas.py`. Every op is a `torch.autograd.Function`: a
CUDA tensor goes through the kernels in both directions, a CPU tensor through
the plain versions.

Weights come in the kernels' layout: a 3x3 kernel as (9 * Cin, Cout) with row
tap * Cin + ci (the HWIO kernel reshaped), a 1x1 kernel as (Cin, Cout).
With `emit_stats=True` a function returns `(out, (sum, sumsq))`, the
per-(batch, channel) float32 sums of `out` — the producer half of the chained
GroupNorm(1) statistics (ucdir_tpu_torch/models/dy3h.py).

The ops (K2, K3, K7, and K6 backward) also take bfloat16 operands, all of
one dtype, and return bfloat16: the TPU kernels' bf16 instantiation, which
validation and training run under `--compute_dtype bf16`. The kernel and
the plain version alike compute in float32 on the operands' values and
round where the TPU kernel's bf16 arithmetic rounds (`staged_affine`; the
output once, to nearest even); the statistics are float32 sums of the
rounded output, and the gradients float32 sums rounded once.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ucdir_tpu_torch.ops import _build
from ucdir_tpu_torch.ops.stats import fold_stats_grad, gn1_stats_plain


def swish(x):
    return x * torch.sigmoid(x)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


def _f32(t):
    return None if t is None else t.float()


def rounded(v, dtype):
    """float32 `v` rounded to `dtype` (to nearest even) and back to float32:
    a value the TPU kernel's bf16 arithmetic rounds, which a bf16 kernel here
    keeps in float32 as it computes."""
    return v.to(dtype).float()


def staged_affine(x, a, t):
    """`x * a + t` of NHWC x and (B, C) a, t of one low-precision dtype, as
    the TPU kernels' staging computes it in that dtype (`_stage_padfree` of
    ucdir_tpu/ops/akgm_pallas.py): the product rounded, then the sum
    rounded. Returns float32."""
    dt = x.dtype
    p = rounded(x.float() * a.float()[:, None, None, :], dt)
    return rounded(p + t.float()[:, None, None, :], dt)


def conv3x3_plain(x, w, bias, *, stride=1, act=None, norm_scale=None,
                  norm_shift=None, emit_stats=False):
    """The plain version of K2: `conv3x3(x * a + t)` with SAME padding 1 of
    the affine's output, + bias, optional swish. bfloat16: the affine as
    `staged_affine`, the float32 convolution, the output rounded once."""
    if x.dtype == torch.bfloat16:
        xs = (x.float() if norm_scale is None
              else staged_affine(x, norm_scale, norm_shift))
        y = conv3x3_plain(xs, w.float(), _f32(bias), stride=stride,
                          act=act).to(x.dtype)
        return (y, gn1_stats_plain(y)) if emit_stats else y
    cin, cout = x.shape[-1], w.shape[1]
    if norm_scale is not None:
        x = x * norm_scale[:, None, None, :] + norm_shift[:, None, None, :]
    k = w.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    y = _nhwc(F.conv2d(_nchw(x), k, bias, stride=stride, padding=1))
    if act == 'swish':
        y = swish(y)
    return (y, gn1_stats_plain(y)) if emit_stats else y


def dswish(z):
    """d swish(z) / dz."""
    sig = torch.sigmoid(z)
    return sig * (1. + z * (1. - sig))


def vjp_of_plain(fn, inputs, cotangents):
    """The gradients of the plain composition `fn(*inputs)` with respect to
    every input that is not None, for the cotangents of its (flattened)
    outputs: the backward of the ops that owe no kernel (the JAX package
    takes the vjp of its XLA composition there)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in inputs]
        outs = _flat(fn(*leaves))
    pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
    grads = iter(torch.autograd.grad(
        [o for o, _ in pairs], [t for t in leaves if t is not None],
        [g for _, g in pairs], allow_unused=True))
    return tuple(None if t is None else next(grads) for t in leaves)


def _flat(out):
    if isinstance(out, tuple):
        return [t for o in out for t in _flat(o)]
    return [out]


# K2's bf16 form (`csrc/igemm_tc.cuh`) stores the statistics of each pixel
# tile of 8 x 16 output pixels into a (B, 2, cout, tiles) float32 workspace
# that the wrapper allocates, and adds the tiles in a fixed order.
STATS_TILE = (8, 16)


def stats_tiles(Ho, Wo):
    """The pixel tiles of an Ho x Wo output (the entry point checks the
    count as for `pc_stats_tiles`)."""
    return -(-Ho // STATS_TILE[0]) * -(-Wo // STATS_TILE[1])


def pc_stats_tiles(Ho, Wo, cout):
    """The pixel tiles of K2's float32 form (`csrc/igemm_pc.cuh`
    `conv_tile_rows`: 128 output pixels a tile at cout >= 128 or cout <= 8,
    else 256), whose statistics it stores into a (B, tiles, 2, cout) float32
    workspace and adds in a fixed order. The entry point is passed the
    count and launches nothing where it differs from its own."""
    rows = 128 if cout >= 128 or cout <= 8 else 256
    return -(-(Ho * Wo) // rows)


def _conv3x3_forward(x, w, bias, stride, act, norm_scale, norm_shift,
                     emit_stats):
    """(out, sum, sumsq), the last two None without emit_stats: K2 on a CUDA
    tensor, its plain version on a CPU tensor."""
    if _build.on_host(x):
        y = conv3x3_plain(x, w, bias, stride=stride, act=act,
                          norm_scale=norm_scale, norm_shift=norm_shift,
                          emit_stats=emit_stats)
        return (y[0], *y[1]) if emit_stats else (y, None, None)
    B, H, W, cin = x.shape
    cout = w.shape[1]
    dev, dt = x.device, x.dtype
    kernel = _build.entry('conv3x3', x)
    _build.check('x', x, dtype=dt)
    _build.check('w', w, (9 * cin, cout), device=dev, dtype=dt)
    _build.check('bias', bias, (cout,), device=dev, dtype=dt)
    _build.check('norm_scale', norm_scale, (B, cin), device=dev, dtype=dt)
    _build.check('norm_shift', norm_shift, (B, cin), device=dev, dtype=dt)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty(B, Ho, Wo, cout, device=dev, dtype=dt)
    s = q = ws = None
    if emit_stats:
        # per-tile sums in a workspace, added in a fixed order into sums the
        # kernel writes whole
        s = torch.empty(B, cout, device=dev, dtype=torch.float32)
        q = torch.empty(B, cout, device=dev, dtype=torch.float32)
        shape = ((B, 2, cout, stats_tiles(Ho, Wo)) if dt == torch.bfloat16
                 else (B, pc_stats_tiles(Ho, Wo, cout), 2, cout))
        ws = torch.empty(shape, device=dev, dtype=torch.float32)
    _build.launch(kernel, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  _build.ptr(norm_scale), _build.ptr(norm_shift),
                  out.data_ptr(), _build.ptr(s), _build.ptr(q),
                  _build.ptr(ws), B, H, W, cin, cout, stride,
                  int(act == 'swish'),
                  0 if ws is None else ws.shape[3 if dt == torch.bfloat16
                                                else 1],
                  _build.stream(x),
                  form=_build.form(norm_scale, act))
    return out, s, q


def conv3x3_backward_plain(x, w, bias, go, *, act=None, norm_scale=None,
                           norm_shift=None):
    """The plain version of K6: (dxh, dw, dbias) of the stride-1 conv3x3,
    dxh the gradient of the affine's output x * a + t. bfloat16: as B9
    computes in bf16 (`_conv_bwd_kernel` of ucdir_tpu/ops/conv_pallas.py),
    on the operands' values in float32: the affine as `staged_affine`, z in
    float32, dz = go * swish'(z) rounded once (without swish, go itself),
    the transposed convolution of that dz and its float32 sums dw and dbias
    each rounded once."""
    cin, cout = x.shape[-1], w.shape[1]
    low = x.dtype if x.dtype == torch.bfloat16 else None
    if low is not None:
        x = (x.float() if norm_scale is None
             else staged_affine(x, norm_scale, norm_shift))
        w, bias, go = w.float(), bias.float(), go.float()
    elif norm_scale is not None:
        x = x * norm_scale[:, None, None, :] + norm_shift[:, None, None, :]
    k = w.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    xn, dz = _nchw(x), _nchw(go)
    if act == 'swish':
        dz = dz * dswish(F.conv2d(xn, k, bias, padding=1))
        if low is not None:
            dz = rounded(dz, low)
    dxh = _nhwc(F.conv_transpose2d(dz, k, padding=1))
    dk = torch.nn.grad.conv2d_weight(xn, k.shape, dz, padding=1)
    dw = dk.permute(2, 3, 1, 0).reshape(9 * cin, cout)
    grads = dxh, dw, dz.sum(dim=(0, 2, 3))
    return grads if low is None else tuple(g.to(low) for g in grads)


# The weight gradients of K5 and K6 (`csrc/igemm_pc.cuh`, wgrad_pc_kernel;
# in bf16 `csrc/igemm_tc.cuh`, wgrad_tc_kernel) cut the batch's pixels into S
# chunks and reduce the S partial tiles in a fixed order from a workspace of
# S x (K + 1) x N floats, which the wrapper allocates. The plan below mirrors
# the kernels' tile rules (launch_wgrad: by width for one group, as K2's by
# cout; for K5's groups the widest tile whose columns divide a group's;
# launch_wgrad_tc: 128 rows of dW by 128 columns for K6 from 128, else 64)
# and holds the workspace under WGRAD_CAP_BYTES.
WGRAD_CAP_BYTES = 64 * 2 ** 20
WGRAD_MIN_CHUNK = 256        # pixels per block at least


def wgrad_tile(group_cols, K, N, tensor_cores=False):
    """(BM, BN, blocks an SM holds) of the weight-gradient tile of K rows and
    N columns in groups of `group_cols`, as the kernel chooses (by its D
    loader: K6's is one group, group_cols = N; K5's groups of C < N): one
    group by width, 128 x 128, 64 x 64 (K <= 64), 96 x 64 (K <= 96), 256 x
    64 or 128 x 8; several (K5) the widest of those whose columns divide a
    group's, else 32, 16 or 8 columns by 64 rows (K <= 64) or 128, so that
    no tile straddles two groups. On the tensor cores (bf16): 128 rows by
    128 columns for one group of 128 or more (K6), else by 64 (K5 loads its
    rebuilt dz a slice ahead into registers), one block an SM; a tile holds
    min(BN, group_cols) columns of one group."""
    if tensor_cores:
        return 128, 128 if group_cols >= max(N, 128) else 64, 1
    one = group_cols >= N
    if (group_cols >= 128 if one else group_cols % 128 == 0):
        return 128, 128, 1
    if (group_cols > 8 if one else group_cols % 64 == 0):
        if K <= 64:
            return 64, 64, 4
        return (96, 64, 2) if K <= 96 else (256, 64, 1)
    if one:
        return 128, 8, 1
    bn = next(bn for bn in (32, 16, 8) if group_cols % bn == 0)
    if K <= 64:
        return 64, bn, 4
    # 128 x 32: 192 threads of up to 255 registers, one block an SM; 128 x
    # 16 and 128 x 8 fit two
    return 128, bn, 1 if bn == 32 else 2


def tc_merge(cin):
    """How many groups of `cin` channels the tensor cores' grouped products
    (K1's bf16 product, K5's z recompute and weight gradient) merge into
    one, so that a merged group's channels are a multiple of 8 (the vector
    staging): the least power of two that makes them so."""
    m = 1
    while (m * cin) % 8 and m < 8:
        m *= 2
    return m


def wgrad_tiles(K, N, group_cols, tensor_cores=False, ones=False):
    """The tiles of a (K x N) weight gradient's grid: on the tensor cores
    K + 1 rows where the bias is a row of the product (`ones`: K6), and
    min(BN, group_cols) columns of one group a tile, K5's groups merged by
    `tc_merge` (m times the rows and the columns a group)."""
    bm, bn, _ = wgrad_tile(group_cols, K, N, tensor_cores)
    if not tensor_cores:
        return -(-K // bm) * -(-N // bn)
    m = tc_merge(K // 9) if group_cols < N else 1
    K, group_cols = m * K, m * group_cols
    width = min(bn, group_cols)
    return (-(-(K + ones) // bm) * (N // group_cols)
            * -(-group_cols // width))


def wgrad_splits(K, N, group_cols, npix, sms=132, tensor_cores=False,
                 ones=False):
    """The number of pixel chunks S of a (K x N) weight gradient over `npix`
    pixels: the least S whose grid fills the `sms` SMs (as many blocks as an
    SM holds) to 90% in its last wave and in all, within the workspace cap
    and the least chunk; the most that the cap and the chunk allow where
    none does."""
    per_sm = wgrad_tile(group_cols, K, N, tensor_cores)[2]
    tiles = wgrad_tiles(K, N, group_cols, tensor_cores, ones)
    slots = sms * per_sm
    most = max(1, min(WGRAD_CAP_BYTES // (4 * (K + 1) * N),
                      -(-npix // WGRAD_MIN_CHUNK)))
    for s in range(1, most + 1):
        blocks = tiles * s
        if blocks >= 0.9 * slots * -(-blocks // slots):
            return s
    return most


def wgrad_workspace(K, N, group_cols, npix, device, tensor_cores=False,
                    ones=False):
    """(S, the (S, K + 1, N) workspace) for a weight gradient on `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    s = wgrad_splits(K, N, group_cols, npix, sms, tensor_cores, ones)
    return s, torch.empty(s, K + 1, N, device=device, dtype=torch.float32)


def conv3x3_backward_kernel(x, w, bias, go, act, norm_scale, norm_shift):
    """K6 on CUDA tensors, every operand float32 or every one bfloat16:
    (dxh, dw, dbias) of that dtype."""
    B, H, W, cin = x.shape
    cout = w.shape[1]
    dev, dt = x.device, x.dtype
    kernel = _build.entry('conv3x3_bwd', x)
    _build.check('x', x, dtype=dt)
    _build.check('go', go, (B, H, W, cout), device=dev, dtype=dt)
    _build.check('w', w, (9 * cin, cout), device=dev, dtype=dt)
    _build.check('bias', bias, (cout,), device=dev, dtype=dt)
    _build.check('norm_scale', norm_scale, (B, cin), device=dev, dtype=dt)
    _build.check('norm_shift', norm_shift, (B, cin), device=dev, dtype=dt)
    # the transposed convolution's weights: taps flipped, channels swapped
    wf = (w.reshape(9, cin, cout).flip(0).permute(0, 2, 1)
          .reshape(9 * cout, cin).contiguous())
    dz = torch.empty_like(go) if act == 'swish' else None
    dxh = torch.empty_like(x)
    dw = torch.empty_like(w)
    dbias = torch.empty_like(bias)
    # bf16: the tensor cores' weight gradient, its bias a row of ones
    tc = dt == torch.bfloat16
    splits, ws = wgrad_workspace(9 * cin, cout, cout, B * H * W, dev,
                                 tensor_cores=tc, ones=tc)
    _build.launch(kernel, x.data_ptr(), go.data_ptr(), w.data_ptr(),
                  wf.data_ptr(), bias.data_ptr(), _build.ptr(norm_scale),
                  _build.ptr(norm_shift), _build.ptr(dz), dxh.data_ptr(),
                  dw.data_ptr(), dbias.data_ptr(), ws.data_ptr(), B, H, W,
                  cin, cout, int(act == 'swish'), splits, _build.stream(x),
                  form=_build.form(norm_scale, act))
    return dxh, dw, dbias


def conv3x3_backward(x, w, bias, go, *, act=None, norm_scale=None,
                     norm_shift=None):
    """Every gradient of the stride-1 `conv3x3` for the output cotangent
    `go`: (dx, dw, dbias, dnorm_scale, dnorm_shift), the last two None
    without the affine. K6 on CUDA tensors, its plain version on the CPU;
    the affine's own gradients are plain tensor ops on either."""
    if _build.on_host(x):
        dxh, dw, dbias = conv3x3_backward_plain(
            x, w, bias, go, act=act, norm_scale=norm_scale,
            norm_shift=norm_shift)
    else:
        dxh, dw, dbias = conv3x3_backward_kernel(
            x, w, bias, go.contiguous(), act, norm_scale, norm_shift)
    if norm_scale is None:
        return dxh, dw, dbias, None, None
    dx, dns, dnt = affine_grads(dxh, x, norm_scale, norm_shift)
    return dx, dw, dbias, dns, dnt


def affine_grads(dxh, x, norm_scale, norm_shift):
    """(dx, dnorm_scale, dnorm_shift) from dxh, the gradient of the affine's
    output x * a + t: dx = dxh * a in dxh's dtype, and the float32 sums over
    the pixels of dxh * x and of dxh, rounded to the affine's dtype (as
    `_conv3x3_backward` of ucdir_tpu/ops/conv_pallas.py ends). Overwrites
    dxh's float32 copy, which is dxh itself where dxh is float32."""
    dx = dxh * norm_scale[:, None, None, :]
    dxf = dxh.float()
    dnt = dxf.sum(dim=(1, 2))
    dns = dxf.mul_(x).sum(dim=(1, 2))
    return dx, dns.to(norm_scale.dtype), dnt.to(norm_shift.dtype)


class _Conv3x3(torch.autograd.Function):
    """Forward K2. Backward: the statistics' cotangents fold into the
    output's (`fold_stats_grad`), then K6 at stride 1; stride 2 (Downsample)
    owes no kernel: the autograd of the plain version, as the JAX package
    takes the vjp of its XLA composition (`_dcs_bwd`)."""

    @staticmethod
    def forward(ctx, x, w, bias, norm_scale, norm_shift, stride, act,
                emit_stats):
        ctx.set_materialize_grads(False)
        out, s, q = _conv3x3_forward(x, w, bias, stride, act, norm_scale,
                                     norm_shift, emit_stats)
        ctx.save_for_backward(x, w, bias, norm_scale, norm_shift,
                              out if emit_stats else None)
        ctx.conf = (stride, act, emit_stats)
        return (out, s, q) if emit_stats else out

    @staticmethod
    def backward(ctx, g, ds=None, dq=None):
        x, w, bias, ns, nt, out = ctx.saved_tensors
        stride, act, emit_stats = ctx.conf
        if emit_stats:
            g = fold_stats_grad(g, out, ds, dq)
        if stride != 1:
            grads = vjp_of_plain(
                lambda *a: conv3x3_plain(
                    a[0], a[1], a[2], stride=stride, act=act,
                    norm_scale=a[3], norm_shift=a[4]),
                (x, w, bias, ns, nt), (g,))
            return (*grads, None, None, None)
        return (*conv3x3_backward(x, w, bias, g, act=act, norm_scale=ns,
                                  norm_shift=nt), None, None, None)


def conv3x3(x, w, bias, *, stride=1, act=None, norm_scale=None,
            norm_shift=None, emit_stats=False):
    """3x3 convolution of NHWC `x` with SAME padding 1 and stride 1 or 2,
    differentiable in x, w, bias and the affine.

    norm_scale, norm_shift (B, Cin): an input affine `x * a + t` (a folded
    GroupNorm(1)); the padding holds the affine's zero. act: None or 'swish'.
    """
    if stride not in (1, 2):
        raise ValueError('stride must be 1 or 2, got %r' % (stride,))
    if act not in (None, 'swish'):
        raise ValueError('act must be None or swish, got %r' % (act,))
    if (norm_scale is None) != (norm_shift is None):
        raise ValueError('norm_scale and norm_shift come together')
    y = _Conv3x3.apply(x, w, bias, norm_scale, norm_shift, stride, act,
                       emit_stats)
    return (y[0], (y[1], y[2])) if emit_stats else y


def conv3x3_preact_plain(x, w, bias, norm_scale, norm_shift):
    """The plain version of K7 (`_c3p_ref` of ucdir_tpu/ops/conv_pallas.py):
    `conv3x3(swish(x * a + t)) + bias`, SAME padding 1 of the activated
    tensor. bfloat16: u = `staged_affine`, the swish staged as the TPU
    kernel's bf16 staging computes it, u * sigmoid(u) with the sigmoid and
    the product each rounded, then the float32 convolution, the output
    rounded once."""
    if x.dtype == torch.bfloat16:
        dt = x.dtype
        u = staged_affine(x, norm_scale, norm_shift)
        xs = rounded(u * rounded(torch.sigmoid(u), dt), dt)
        return conv3x3_plain(xs, w.float(), _f32(bias)).to(dt)
    xh = x * norm_scale[:, None, None, :] + norm_shift[:, None, None, :]
    return conv3x3_plain(swish(xh), w, bias)


class _Conv3x3Preact(torch.autograd.Function):
    """Forward K7; the backward is the autograd of the plain composition, as
    in the JAX package (`_c3p_bwd`), which owes no kernel here."""

    @staticmethod
    def forward(ctx, x, w, bias, norm_scale, norm_shift):
        ctx.save_for_backward(x, w, bias, norm_scale, norm_shift)
        if _build.on_host(x):
            return conv3x3_preact_plain(x, w, bias, norm_scale, norm_shift)
        B, H, W, cin = x.shape
        cout = w.shape[1]
        dev, dt = x.device, x.dtype
        kernel = _build.entry('conv3x3_preact', x)
        _build.check('x', x, dtype=dt)
        _build.check('w', w, (9 * cin, cout), device=dev, dtype=dt)
        _build.check('bias', bias, (cout,), device=dev, dtype=dt)
        _build.check('norm_scale', norm_scale, (B, cin), device=dev, dtype=dt)
        _build.check('norm_shift', norm_shift, (B, cin), device=dev, dtype=dt)
        out = torch.empty(B, H, W, cout, device=dev, dtype=dt)
        _build.launch(kernel, x.data_ptr(), w.data_ptr(),
                      bias.data_ptr(), norm_scale.data_ptr(),
                      norm_shift.data_ptr(), out.data_ptr(), B, H, W, cin,
                      cout, _build.stream(x))
        return out

    @staticmethod
    def backward(ctx, g):
        return vjp_of_plain(conv3x3_preact_plain, ctx.saved_tensors, (g,))


def conv3x3_preact(x, w, bias, norm_scale, norm_shift):
    """`conv3x3(swish(x * a + t)) + bias` on NHWC `x`: a GroupNorm(1) ->
    swish -> conv head as one pass, the norm as the affine norm_scale,
    norm_shift (B, Cin). The padding is the activated tensor's 0. No
    statistics and no activation after the conv; differentiable in every
    operand."""
    return _Conv3x3Preact.apply(x, w, bias, norm_scale, norm_shift)


def conv1x1_plain(x, w, bias, *, act=None):
    """The plain version of K3: a per-pixel (Cin -> Cout) product + bias.
    bfloat16: the float32 product, the output rounded once."""
    if x.dtype == torch.bfloat16:
        return conv1x1_plain(x.float(), w.float(), bias.float(),
                             act=act).to(x.dtype)
    y = (x.reshape(-1, x.shape[-1]) @ w + bias).reshape(
        *x.shape[:-1], w.shape[1])
    return swish(y) if act == 'swish' else y


def _conv1x1_forward(x, w, bias, act):
    if _build.on_host(x):
        return conv1x1_plain(x, w, bias, act=act)
    B, H, W, cin = x.shape
    cout = w.shape[1]
    dev, dt = x.device, x.dtype
    kernel = _build.entry('conv1x1', x)
    _build.check('x', x, dtype=dt)
    _build.check('w', w, (cin, cout), device=dev, dtype=dt)
    _build.check('bias', bias, (cout,), device=dev, dtype=dt)
    out = torch.empty(B, H, W, cout, device=dev, dtype=dt)
    _build.launch(kernel, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), B, H, W, cin, cout, int(act == 'swish'),
                  _build.stream(x))
    return out


class _Conv1x1(torch.autograd.Function):
    """Forward K3; the backward is the autograd of the plain composition, as
    in the JAX package (`_c1_bwd`), which owes no kernel here."""

    @staticmethod
    def forward(ctx, x, w, bias, act):
        ctx.save_for_backward(x, w, bias)
        ctx.act = act
        return _conv1x1_forward(x, w, bias, act)

    @staticmethod
    def backward(ctx, g):
        act = ctx.act
        return (*vjp_of_plain(lambda x, w, b: conv1x1_plain(x, w, b, act=act),
                              ctx.saved_tensors, (g,)), None)


def conv1x1(x, w, bias, *, act=None):
    """1x1 convolution of NHWC `x` with w (Cin, Cout), + bias, optional
    swish; differentiable in x, w and bias."""
    if act not in (None, 'swish'):
        raise ValueError('act must be None or swish, got %r' % (act,))
    return _Conv1x1.apply(x, w, bias, act)


# nearest-x2 + 3x3 SAME conv is one conv at SOURCE resolution with
# phase-packed weights: output row 2y + py reads source rows {y-1, y} (py=0)
# or {y, y+1} (py=1), the taps that land on one source row summed. Exact.
_PHASE_M = np.array([[[1, 0, 0], [0, 1, 1], [0, 0, 0]],     # py/px == 0
                     [[0, 0, 0], [1, 1, 0], [0, 0, 1]]], np.float32)


def pack_up_kernel(kernel_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (3, 3, Cin, 4 * Cout), packed output channel
    (py * 2 + px) * Cout + o. bfloat16: as the TPU package's einsum in that
    dtype computes it, two products each rounded, the row taps that land on
    one source row added first, then the column taps."""
    dt = kernel_hwio.dtype
    m = torch.as_tensor(_PHASE_M, device=kernel_hwio.device)
    if dt == torch.bfloat16:
        rows = rounded(torch.einsum('pay,yxio->paxio', m,
                                    kernel_hwio.float()), dt)
        k = torch.einsum('paxio,qbx->abipqo', rows, m).to(dt)
    else:
        m = m.to(dt)
        k = torch.einsum('pay,yxio,qbx->abipqo', m, kernel_hwio, m)
    return k.reshape(3, 3, kernel_hwio.shape[2], 4 * kernel_hwio.shape[3])


def depth_to_space2(y):
    """(B, H, W, 4 * C) phase-major -> (B, 2H, 2W, C)."""
    B, H, W, C4 = y.shape
    C = C4 // 4
    y = y.reshape(B, H, W, 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * H, 2 * W, C)


def upconv2x(x, w_packed, bias_packed, *, emit_stats=False):
    """Nearest-x2 upsampling then a 3x3 SAME conv, as K2 on phase-packed
    weights (9 * Cin, 4 * Cout) and the bias tiled 4 times, then
    depth-to-space. The packed output is a permutation of the upsampled
    tensor, so its statistics summed over the 4 phases are the upsampled
    tensor's (B, Cout) statistics."""
    y = conv3x3(x, w_packed, bias_packed, emit_stats=emit_stats)
    if not emit_stats:
        return depth_to_space2(y)
    y, (s, q) = y
    B, cout = s.shape[0], s.shape[1] // 4
    return depth_to_space2(y), (s.reshape(B, 4, cout).sum(1),
                                q.reshape(B, 4, cout).sum(1))
