"""The layouts and plans of the forward AKGM kernels K1 and K8 that the
wrappers own, checked on the CPU (the kernels themselves need the card:
tests/test_torch_port_gpu.py).

- The tile of the grouped product (`ucdir_tpu_torch/ops/akgm.py`
  `tail_tile`) lies in one group at every width the kernels take (C a
  multiple of 8), and the column permutation within each tile
  (`tile_columns`) gives a consumer thread of `csrc/igemm_pc.cuh` one
  channel's 8 candidates, on the narrow tiles of 8, 16 and 32 columns too.
- The product on permuted columns, read the way the kernel's epilogue reads
  it (a thread's 8 accumulators, mix += (acc + b_j) * (att_j * attw_j) for
  j = 0..7, swish, residual), is `akgm_block_tail_plain`, and without the
  tail's extras `akgm_mix_reference`.
- The statistics: per (image, pixel tile of `stats_tiles`) partial sums,
  added as `stats_reduce_kernel` adds them (32 runs of consecutive tiles in
  ascending order, then the runs in ascending order), are `gn1_stats_plain`.
- At C = 8, the plain versions against the JAX package (`ucdir_tpu.ops.akgm`)
  on the same numpy inputs.

Tolerance: the emulated product and the plain version add the same products
in other orders: 1e-6 of max(1, largest) on outputs in float32; statistics
1e-5 of the largest sum of squares, as the kernels' GPU tests; against the
JAX package 1e-5 abs / 1e-4 rel, as tests/test_torch_port_ops.py.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ucdir_tpu.ops import akgm as jax_akgm
from ucdir_tpu_torch.ops import akgm, conv, stats

G = 8
WIDTHS = [8, 16, 24, 32, 40, 64, 96, 128, 192, 256, 512]


def tile_col(bn, tn, j):
    """Column j of consumer thread tn in a tile of 8-column threads
    (igemm_pc.cuh tile_col: two groups of 4, bn / 2 apart)."""
    return (j // 4) * (bn // 2) + tn * 4 + j % 4


@pytest.mark.parametrize('C', WIDTHS)
def test_tail_tile_lies_in_one_group(C):
    bm, bn = akgm.tail_tile(C)
    assert C % bn == 0 and bn in (8, 16, 32, 64, 128)
    assert (bm, bn) == ((128, 128) if C % 128 == 0 else
                        (256, 64) if C % 64 == 0 else (128, bn))
    # the widest that divides C
    assert all(C % wider for wider in (16, 32, 64, 128) if wider > bn)
    assert akgm.stats_tiles(1000, C) == -(-1000 // bm)


@pytest.mark.parametrize('C', [8, 16, 32])
def test_narrow_tile_columns_give_a_thread_one_channel(C):
    bn = akgm.tail_tile(C)[1]
    assert bn == C                   # as wide as the group
    cols = akgm.tile_columns(C * G, bn)
    assert torch.equal(torch.sort(cols).values, torch.arange(C * G))
    assert torch.equal(cols // bn, torch.arange(C * G) // bn)
    for tile in range(C * G // bn):
        for tn in range(bn // G):
            phys = [tile * bn + tile_col(bn, tn, j) for j in range(G)]
            assert cols[phys].tolist() == [tile * bn + tn * G + j
                                           for j in range(G)]
    if C == 8:                       # one channel a tile: no permutation
        assert torch.equal(cols, torch.arange(C * G))


def operands(rng, B, H, W, C):
    def t(*shape, scale=1.0, off=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale + off).astype(np.float32))
    return dict(h=t(B, H, W, C, scale=0.5), res=t(B, H, W, C, scale=0.5),
                att=t(B, H, W, G, scale=0.5), attw=t(B, G, scale=0.3, off=1.),
                w=t(9 * C // G, C * G, scale=(9 * C / G) ** -0.5),
                bias=t(C * G, scale=0.1), ns=t(B, C, scale=0.2, off=1.),
                nt=t(B, C, scale=0.2))


def emulated_tail(d, fold, tail):
    """What K1 (tail) or K8 computes, read the kernel's way: the grouped
    product on `permuted_columns(w)`, thread (tile, tn)'s physical columns
    tile_col(bn, tn, j) taken as channel tile * bn / 8 + tn's candidate j,
    then the epilogue in its order."""
    h, w = d['h'], d['w']
    B, H, W, C = h.shape
    bn = akgm.tail_tile(C)[1]
    if fold:
        h = h * d['ns'][:, None, None, :] + d['nt'][:, None, None, :]
    k = akgm.permuted_columns(w).reshape(3, 3, C // G, C * G)
    acc = F.conv2d(h.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1,
                   groups=G).permute(0, 2, 3, 1)          # (B, H, W, C * G)
    out = torch.empty_like(d['h'])
    for tile in range(C * G // bn):
        for tn in range(bn // G):
            ch = tile * bn // G + tn
            mix = torch.zeros(B, H, W)
            for j in range(G):
                a = acc[..., tile * bn + tile_col(bn, tn, j)]
                aw = d['attw'][:, j, None, None] if tail else 1.0
                mix = mix + (a + d['bias'][ch * G + j]) * (d['att'][..., j]
                                                           * aw)
            out[..., ch] = conv.swish(mix) + d['res'][..., ch] if tail \
                else mix
    return out


def close(got, want, tol=1e-6):
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize('C', [8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize('fold', [False, True])
def test_forward_product_on_permuted_columns_is_the_tail(C, fold):
    d = operands(np.random.default_rng(C), 2, 5, 7, C)
    kw = dict(attw=d['attw'])
    if fold:
        kw.update(norm_scale=d['ns'], norm_shift=d['nt'])
    close(emulated_tail(d, fold, True),
          akgm.akgm_block_tail_plain(d['h'], d['att'], d['w'], d['bias'],
                                     d['res'], G, **kw))


@pytest.mark.parametrize('C', [8, 16, 32, 64, 256])
def test_forward_product_on_permuted_columns_is_the_mix(C):
    d = operands(np.random.default_rng(C + 1), 1, 6, 5, C)
    close(emulated_tail(d, False, False),
          akgm.akgm_mix_reference(d['h'], d['att'], d['w'], d['bias'], G))


def reduce_runs(ntp):
    """The tiles that stats_reduce_kernel's warp w adds, in its order: 32
    runs of ceil(ntp / 32) consecutive tiles (the last ones short or
    empty)."""
    run = -(-ntp // 32)
    return [list(range(w * run, min(ntp, (w + 1) * run))) for w in range(32)]


@pytest.mark.parametrize('ntp', [1, 5, 31, 32, 33, 100, 13916])
def test_reduce_runs_take_every_tile_once_in_ascending_order(ntp):
    order = [t for run in reduce_runs(ntp) for t in run]
    assert order == list(range(ntp))


@pytest.mark.parametrize('B,H,W,C', [(2, 17, 19, 8), (1, 40, 37, 64),
                                     (3, 9, 30, 128), (1, 26, 50, 32)])
def test_statistics_plan_reproduces_gn1_stats(B, H, W, C):
    rng = np.random.default_rng(B * H)
    out = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32) + 0.5)
    P = H * W
    bm = akgm.tail_tile(C)[0]
    ntp = akgm.stats_tiles(P, C)
    assert (ntp - 1) * bm < P <= ntp * bm
    flat = out.reshape(B, P, C)
    # the (B, ntp, 2, C) workspace: one partial per image, tile and channel
    ws = torch.stack([torch.stack([flat[:, t * bm:(t + 1) * bm].sum(1),
                                   (flat[:, t * bm:(t + 1) * bm] ** 2).sum(1)],
                                  1) for t in range(ntp)], 1)
    assert ws.shape == (B, ntp, 2, C)
    s = torch.zeros(B, C)
    q = torch.zeros(B, C)
    for run in reduce_runs(ntp):
        rs, rq = torch.zeros(B, C), torch.zeros(B, C)
        for t in run:
            rs, rq = rs + ws[:, t, 0], rq + ws[:, t, 1]
        s, q = s + rs, q + rq
    want_s, want_q = stats.gn1_stats_plain(out)
    scale = want_q.abs().max().item()
    assert (s - want_s).abs().max().item() <= 1e-5 * scale
    assert (q - want_q).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize('fold', [False, True])
def test_tail_and_mix_at_c8_match_jax(fold):
    rng = np.random.default_rng(8)
    d = operands(rng, 2, 6, 9, 8)
    kw = dict(attw=d['attw'])
    jkw = dict(attw=jnp.asarray(d['attw'].numpy()))
    if fold:
        kw.update(norm_scale=d['ns'], norm_shift=d['nt'])
        jkw.update(norm_scale=jnp.asarray(d['ns'].numpy()),
                   norm_shift=jnp.asarray(d['nt'].numpy()))
    k = d['w'].reshape(3, 3, 1, 8 * G).numpy()
    J = {n: jnp.asarray(d[n].numpy()) for n in ('h', 'att', 'bias', 'res')}
    want = jax_akgm.akgm_block_tail(J['h'], J['att'], jnp.asarray(k),
                                    J['bias'], J['res'], G, **jkw)
    got = akgm.akgm_block_tail(d['h'], d['att'], d['w'], d['bias'], d['res'],
                               G, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    want = jax_akgm.akgm_mix_reference(J['h'], J['att'], jnp.asarray(k),
                                       J['bias'], G)
    got = akgm.akgm_mix(d['h'], d['att'], d['w'], d['bias'], G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
