"""Tensor-core arithmetic emulated in plain PyTorch on the CPU.

The 3xTF32 product: what a tensor-core form of the float32 convolutions K2,
K3 and K7 computes, and what any later one has to keep. K2, K3 and K7 ship
with an fp32 FMA product in float32 (`ucdir_tpu_torch/csrc/igemm_pc.cuh`);
the tensor-core form was built and measured in the same pipeline (PERF.md).
It multiplies in TF32 with the 3xTF32 split: every staged value v becomes hi
= rna_tf32(v) and lo = rna_tf32(v - hi), and a k8 step of the product is lo
* hi + hi * lo + hi * hi, summed from 0 and added to the running float32 sum.
Here the same arithmetic runs in float32 tensors whose values are TF32
numbers (a product of two of them is exact in float32), rounded to TF32 by
bit arithmetic on the int32 view (round to nearest, ties away from 0, what
`cvt.rna.tf32.f32` does), at the depths K of the main path's shapes and with
the operand scales of `chip_smoke.py`'s cases: downs_0 (K = 54), conv1 192
-> 64 (K = 1728) and conv1 1024 -> 512 (K = 9216).

Tolerances: hi + lo is within 2^-22 of v (2^-23 by the rounding of lo, which
has at most 12 significant bits of which TF32 keeps 11; one bit of margin);
the three-term product's largest error against float64 is within 2x the
float32 product's (both sum k8 partial sums in the same order); the one-term
TF32 product misses 1e-5, the limit the port holds end to end, which is why
a tensor-core product needs the split.

The bf16 product of the bf16 forms of K2, K3 and K7 (`csrc/igemm_tc.cuh`):
wgmma on bf16 operands with float32 accumulators, the sum running over k16
chunks. A product of two bf16 values has at most 16 significant bits, so it
is exact in float32. How the tensor core adds a chunk's products into its
float32 accumulator is its own (it does not round each addition to nearest
as IEEE fmaf does), so this is no model of the card's arithmetic: it bounds
what reordering the float32 sums in k16 chunks does. Emulated here with the
chunk's sum taken in float64 and rounded once into the float32 running sum,
against the sequential fmaf of the FMA core (each step rounded once to
float32), both outputs rounded to bf16: they differ by far less than phase
2's bf16 limit, one bf16 ulp of max(1, largest) (2^-7 of it; `chip_smoke.py`
kernel_cases `kind`), at the same depths and scales. What holds the card's
own accumulation to that limit is phase 2 of `chip_smoke.py` and the GPU
tests (`tests/test_torch_port_gpu.py`).
"""
import numpy as np
import pytest
import torch

TF32_MAX = float(np.float32((2.0 - 2.0 ** -10) * 2.0 ** 127))
DEPTHS = [54, 1728, 9216]


def tf32_rna(x):
    """float32 -> the nearest TF32 number (10 explicit mantissa bits), ties
    away from 0; non-finite values pass."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(v):
    """(hi, lo) as such a kernel stages them: values beyond the largest TF32
    number saturate to it first, a NaN stays a NaN."""
    big = v.abs() > TF32_MAX
    v = torch.where(big, torch.copysign(torch.full_like(v, TF32_MAX), v), v)
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def chunked(k8_step, depth, m, n):
    """sum over the k8 steps of k8_step(slice of k), each added to a float32
    running sum, as such a kernel does."""
    acc = torch.zeros(m, n, dtype=torch.float32)
    for k in range(0, depth, 8):
        acc += k8_step(slice(k, k + 8))
    return acc


def product_fp32(a, b):
    return chunked(lambda k: a[:, k] @ b[k], a.shape[1], a.shape[0],
                   b.shape[1])


def product_3xtf32(a, b):
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
    return chunked(
        lambda k: (a_lo[:, k] @ b_hi[k] + a_hi[:, k] @ b_lo[k])
        + a_hi[:, k] @ b_hi[k], a.shape[1], a.shape[0], b.shape[1])


def operands(K, seed, m=48, n=24):
    """A's rows at the activations' scale (0.5) and Wt at the weights'
    (K ** -0.5), as chip_smoke.py draws them; K padded to a k8 step with
    zeros as the convolutions pad it."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, -(-K // 8) * 8), np.float32)
    b = np.zeros((a.shape[1], n), np.float32)
    a[:, :K] = rng.standard_normal((m, K)) * 0.5
    b[:K] = rng.standard_normal((K, n)) * K ** -0.5
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize('K', DEPTHS)
def test_hi_plus_lo_is_the_value(K):
    for t in operands(K, 0):
        hi, lo = split_tf32(t)
        assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
        err = (hi.double() + lo.double() - t.double()).abs()
        assert (err <= 2.0 ** -22 * t.double().abs()).all()
        # lo is at most half a unit of hi's last place
        assert (lo.abs() <= 2.0 ** -11 * hi.abs() * (1 + 2.0 ** -10)).all()


@pytest.mark.parametrize('K', DEPTHS)
def test_three_terms_are_float32_grade(K):
    a, b = operands(K, 1)
    exact = a.double() @ b.double()
    err3 = (product_3xtf32(a, b).double() - exact).abs().max().item()
    err32 = (product_fp32(a, b).double() - exact).abs().max().item()
    assert err3 <= 2 * err32, (err3, err32)
    assert err3 <= 1e-5 * max(1.0, exact.abs().max().item())


@pytest.mark.parametrize('K', DEPTHS)
def test_one_term_tf32_misses_the_limit(K):
    a, b = operands(K, 2)
    exact = a.double() @ b.double()
    one = product_fp32(split_tf32(a)[0], split_tf32(b)[0])
    assert (one.double() - exact).abs().max().item() > 1e-5


@pytest.mark.parametrize('K', DEPTHS)
def test_inf_huge_and_negative_zero_give_no_nan(K):
    a, b = operands(K, 3)
    a[0, 0], a[1, 1], a[2, 2] = float('inf'), -float('inf'), -0.0
    a[3, 3], a[4, 4] = 3.402e38, -3.4028234e38   # above the largest TF32
    a[5, 5] = TF32_MAX
    hi, lo = split_tf32(a)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert hi[0, 0] == TF32_MAX and hi[1, 1] == -TF32_MAX
    assert lo[0, 0] == 0 and lo[3, 3] == 0 and lo[5, 5] == 0
    assert hi[2, 2] == 0 and lo[2, 2] == 0
    out = product_3xtf32(a, b)
    assert not torch.isnan(out).any()
    # the rows without a saturated value are untouched by their neighbours
    want = product_3xtf32(operands(K, 3)[0], b)
    assert torch.equal(out[6:], want[6:])


def test_a_nan_stays_a_nan():
    v = torch.tensor([float('nan'), 1.0])
    hi, lo = split_tf32(v)
    assert torch.isnan(hi[0]) and hi[1] == 1.0 and lo[1] == 0.0


@pytest.mark.parametrize('value,want', [
    (1.0, 1.0), (-0.0, -0.0), (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0), (1.0 + 3 * 2.0 ** -11,
                                           1.0 + 2.0 ** -9),
    (2.0 - 2.0 ** -12, 2.0), (TF32_MAX, TF32_MAX)])
def test_rounding_is_to_nearest_ties_away(value, want):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want
    assert np.signbit(got.item()) == np.signbit(want)


@pytest.mark.parametrize('K', DEPTHS)
def test_truncating_instead_of_rounding_is_worse(K):
    """Why `rna` and not a mask: a truncated hi leaves a lo of up to a whole
    unit of hi's last place, which TF32 then holds to 2^-21 of v at best."""
    a, _ = operands(K, 4)
    hi = (a.view(torch.int32) & -0x2000).view(torch.float32)
    lo = ((a - hi).view(torch.int32) & -0x2000).view(torch.float32)
    trunc = (hi.double() + lo.double() - a.double()).abs().max().item()
    hi, lo = split_tf32(a)
    rna = (hi.double() + lo.double() - a.double()).abs().max().item()
    assert rna < trunc


BF16 = torch.bfloat16


def bf16_operands(K, seed, m=48, n=24):
    """operands() rounded to bf16, the values both bf16 products see."""
    return tuple(t.to(BF16).float() for t in operands(K, seed, m, n))


def product_fmaf(a, b):
    """The FMA core's product: one float32 accumulator per output, k in
    ascending order, each step a*b + acc rounded once to float32."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = (a[:, k:k + 1].double() * b[k].double()
               + acc.double()).float()
    return acc


def product_k16(a, b):
    """The tensor-core product: each k16 chunk's products summed exactly
    (float64) and added once into the float32 running sum."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 16):
        acc = (acc.double() + a[:, k:k + 16].double()
               @ b[k:k + 16].double()).float()
    return acc


@pytest.mark.parametrize('K', DEPTHS)
def test_bf16_products_are_exact_in_float32(K):
    a, b = bf16_operands(K, 5)
    prod32 = a[:, :, None] * b[None]
    prod64 = a.double()[:, :, None] * b.double()[None]
    assert torch.equal(prod32.double(), prod64)


@pytest.mark.parametrize('K', DEPTHS)
def test_bf16_k16_sums_meet_the_phase2_limit(K):
    """Rounded to bf16, the k16-chunk product and the sequential fmaf
    product differ by less than one bf16 ulp of max(1, largest): reordering
    the float32 sums in k16 chunks stays within phase 2's limit."""
    a, b = bf16_operands(K, 6)
    pad = -a.shape[1] % 16                        # K padded to k16 with 0
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    assert a.shape[1] % 16 == 0
    fma = product_fmaf(a, b).to(BF16).float()
    tc = product_k16(a, b).to(BF16).float()
    limit = 2. ** -7 * max(1.0, fma.abs().max().item())
    err = (tc - fma).abs().max().item()
    assert err <= limit, (err, limit)
    # and both are float32-grade against float64 before the rounding
    exact = a.double() @ b.double()
    for p in (product_fmaf(a, b), product_k16(a, b)):
        assert (p.double() - exact).abs().max().item() <= 1e-5


# ---- the backward's bf16 products on the tensor cores (K5 and K6 in bf16)
#
# The weight gradient (`csrc/igemm_tc.cuh` wgrad_tc_kernel) reduces over
# pixels: each block's chunk of the batch's pixels in 64-pixel slices, four
# k16 steps each, the partial tiles of the chunks added in ascending order by
# `wgrad_reduce_kernel` and rounded to bf16 once. Emulated as above (each k16
# chunk's products summed exactly and rounded once into the float32 running
# sum), at the chunk depths of the tensor cores' plan (`ops/conv.py`
# `wgrad_splits(..., tensor_cores=True)`) at SID train sites at batch 32,
# against the FMA core: its own plan's chunks, each a sequential fmaf, the
# partials added in ascending order. Tolerance: phase 2's bf16 limit.
# K5's z recompute adds a channel's 8 rounded terms m = z * A two in a lane
# and then over the lanes of a quad by two shuffles: ((m0 + m1) + (m2 + m3))
# + ((m4 + m5) + (m6 + m7)), where the FMA core adds them in order; both
# then give do = go * swish'(o) rounded once. Tolerance: the same limit.

# (K, N, group columns, pixels): K6 conv1 192 -> 64 at 288 x 288, K5 at C =
# 64 there, K6 conv1 1024 -> 512 at 36 x 36, all at batch 32
WGRAD_SITES = [(1728, 64, 64, 32 * 288 * 288), (72, 512, 64, 32 * 288 * 288),
               (9216, 512, 512, 32 * 36 * 36)]


def chunk_bounds(npix, splits, step):
    chunk = -(-(-(-npix // splits)) // step) * step
    return [(q, min(q + chunk, npix)) for q in range(0, npix, chunk)]


def wgrad_k16(x, d, bounds):
    """Per chunk, the k16 pixel steps' exact sums rounded once into a
    float32 running sum; the chunks' partials added in ascending order."""
    total = torch.zeros(x.shape[1], dtype=torch.float32)
    for q0, q1 in bounds:
        acc = torch.zeros(x.shape[1], dtype=torch.float32)
        prods = (x[q0:q1].double() * d[q0:q1].double())
        pad = -prods.shape[0] % 16
        prods = torch.nn.functional.pad(prods, (0, 0, 0, pad))
        steps = prods.reshape(-1, 16, x.shape[1]).sum(dim=1)
        for step in steps:
            acc = (acc.double() + step).float()
        total = total + acc
    return total


def wgrad_fmaf(x, d, bounds):
    """Per chunk a sequential fmaf (the products are exact in float32, so a
    float32 running sum of them); the partials added in ascending order."""
    total = np.zeros(x.shape[1], np.float32)
    prods = (x * d).numpy()
    for q0, q1 in bounds:
        total = total + np.add.accumulate(prods[q0:q1], axis=0,
                                          dtype=np.float32)[-1]
    return torch.from_numpy(total)


@pytest.mark.parametrize('K,N,cols,npix', WGRAD_SITES)
def test_bf16_wgrad_pixel_chunks_meet_the_phase2_limit(K, N, cols, npix):
    from ucdir_tpu_torch.ops import conv
    s_tc = conv.wgrad_splits(K, N, cols, npix, tensor_cores=True,
                             ones=cols == N)
    s_fma = conv.wgrad_splits(K, N, cols, npix)
    rng = np.random.default_rng(7)
    n = 4   # outputs (dW entries) emulated in full
    x = torch.from_numpy(rng.standard_normal((npix, n)).astype(np.float32)
                         * 0.5).to(BF16).float()
    d = torch.from_numpy(rng.standard_normal((npix, n)).astype(np.float32)
                         ).to(BF16).float()
    tc = wgrad_k16(x, d, chunk_bounds(npix, s_tc, 64)).to(BF16).float()
    fma = wgrad_fmaf(x, d, chunk_bounds(npix, s_fma, 16)).to(BF16).float()
    limit = 2. ** -7 * max(1.0, fma.abs().max().item())
    assert (tc - fma).abs().max().item() <= limit
    exact = (x.double() * d.double()).sum(dim=0)
    for p in (tc, fma):
        assert ((p.double() - exact).abs() <= 2. ** -7 * exact.abs()
                + 1e-6).all()


def dswish(z):
    sig = torch.sigmoid(z)
    return sig * (1. + z * (1. - sig))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_k5_quad_order_of_the_g_terms_meets_the_limit(seed):
    rng = np.random.default_rng(seed)
    P, C = 4096, 64
    z = torch.from_numpy(rng.standard_normal((P, C, 8)).astype(np.float32))
    A = torch.from_numpy((rng.standard_normal((P, 1, 8)) * 0.5
                          ).astype(np.float32)).to(BF16).float()
    go = torch.from_numpy(rng.standard_normal((P, C)).astype(np.float32)
                          ).to(BF16).float()
    m = (z.to(BF16).float() * A).to(BF16).float()     # each term rounded
    seq = torch.zeros(P, C)
    for j in range(8):
        seq = seq + m[..., j]                          # the FMA core's order
    pairs = [m[..., 2 * i] + m[..., 2 * i + 1] for i in range(4)]
    quad = (pairs[0] + pairs[1]) + (pairs[2] + pairs[3])
    do_seq = (go * dswish(seq)).to(BF16).float()
    do_quad = (go * dswish(quad)).to(BF16).float()
    limit = 2. ** -7 * max(1.0, do_seq.abs().max().item())
    assert (do_quad - do_seq).abs().max().item() <= limit
    # the sums themselves differ by float32 rounding alone
    exact = m.double().sum(dim=-1)
    for o in (seq, quad):
        assert (o.double() - exact).abs().max().item() <= 8 * 2. ** -24 * (
            m.double().abs().sum(dim=-1).max().item())
