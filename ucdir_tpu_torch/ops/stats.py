"""One-pass GroupNorm(1) statistics: kernel K4 (`csrc/gn1_stats.cu`) and its
plain version. Counterpart of `ucdir_tpu/ops/stats_pallas.py`. x may be
float32 or bfloat16; the sums are float32 either way. The bf16 form adds in
a fixed order (the same bits from call to call); the float32 one with
atomics."""
from __future__ import annotations

import torch

from ucdir_tpu_torch.ops import _build


def gn1_stats_plain(x: torch.Tensor):
    """Per-(batch, channel) float32 sum and sum of squares of NHWC `x` (of
    its values as float32, whatever its dtype)."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def gn1_slab(C):
    """Pixels of a slab of K4's bf16 form (`csrc/gn1_stats.cu`): a block of
    256 threads holds min(ceil(C / 8), 32) chunks of 8 channels, so 256 over
    that many pixel rows, each thread adding 32 of them."""
    return 256 // min(-(-C // 8), 32) * 32


def _gn1_stats_forward(x):
    if _build.on_host(x):
        return gn1_stats_plain(x)
    B, H, W, C = x.shape
    kernel = _build.entry('gn1_stats', x)
    _build.check('x', x, dtype=x.dtype)
    if x.dtype == torch.float32:
        # atomics into zeroed sums
        s = torch.zeros(B, C, device=x.device, dtype=torch.float32)
        q = torch.zeros_like(s)
        _build.launch(kernel, x.data_ptr(), s.data_ptr(), q.data_ptr(),
                      B, H * W, C, _build.stream(x))
        return s, q
    # bf16: per slab sums, added in a fixed order
    s = torch.empty(B, C, device=x.device, dtype=torch.float32)
    q = torch.empty_like(s)
    ws = torch.empty(B, -(-H * W // gn1_slab(C)), 2, C, device=x.device,
                     dtype=torch.float32)
    _build.launch(kernel, x.data_ptr(), s.data_ptr(), q.data_ptr(),
                  ws.data_ptr(), B, H * W, C, _build.stream(x))
    return s, q


def fold_stats_grad(g, out, ds, dq):
    """The cotangent of `out` with those of its emitted statistics folded in:
    d(sum)/d(out) = 1 and d(sumsq)/d(out) = 2 * out, added in float32 and
    rounded to out's dtype once (`_c3s_bwd` of ucdir_tpu/ops/conv_pallas.py).
    g, ds, dq may be None (no cotangent)."""
    if g is not None:
        g = g.float()
    if ds is not None:
        ds = ds.float()[:, None, None, :]
        g = ds.expand_as(out) if g is None else g + ds
    if dq is not None:
        dq = 2. * out.float() * dq.float()[:, None, None, :]
        g = dq if g is None else g + dq
    if g is None:
        return torch.zeros_like(out)
    return g.to(out.dtype).contiguous()


class _GN1Stats(torch.autograd.Function):
    """Forward K4; the backward is plain tensor ops, as in the JAX package
    (`_stats_bwd`, which runs outside any kernel)."""

    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        return _gn1_stats_forward(x)

    @staticmethod
    def backward(ctx, ds, dq):
        (x,) = ctx.saved_tensors
        return fold_stats_grad(None, x, ds, dq)


def gn1_stats(x: torch.Tensor):
    """((B, C) sum, (B, C) sum of squares) in float32, in one read of x;
    differentiable in x."""
    return _GN1Stats.apply(x)
