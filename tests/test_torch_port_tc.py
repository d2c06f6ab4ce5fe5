"""The arithmetic of a 3xTF32 product on the tensor cores, emulated in plain
PyTorch on the CPU: what a tensor-core form of the convolutions K2, K3 and K7
computes, and what any later one (wgmma, see ROADMAP.md) has to keep.

K2, K3 and K7 ship with an fp32 FMA product (`ucdir_tpu_torch/csrc/
igemm_pc.cuh`); the tensor-core form was built and measured in the same
pipeline (PERF.md). It multiplies in TF32 with the 3xTF32 split: every
staged value v becomes hi = rna_tf32(v) and lo = rna_tf32(v - hi), and a k8
step of the product is lo * hi + hi * lo + hi * hi, summed from 0 and added to
the running float32 sum. Here the same arithmetic runs in float32 tensors
whose values are TF32 numbers (a product of two of them is exact in float32),
rounded to TF32 by bit arithmetic on the int32 view (round to nearest, ties
away from 0, what `cvt.rna.tf32.f32` does), at the depths K of the main
path's shapes and with the operand scales of `chip_smoke.py`'s cases:
downs_0 (K = 54), conv1 192 -> 64 (K = 1728) and conv1 1024 -> 512 (K =
9216).

Tolerances: hi + lo is within 2^-22 of v (2^-23 by the rounding of lo, which
has at most 12 significant bits of which TF32 keeps 11; one bit of margin);
the three-term product's largest error against float64 is within 2x the
float32 product's (both sum k8 partial sums in the same order); the one-term
TF32 product misses 1e-5, the limit the port holds end to end, which is why
a tensor-core product needs the split.
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
