"""The layouts and plans of the backward kernels K5 and K6 that the wrappers
own, checked on the CPU (the kernels themselves need the card:
tests/test_torch_port_gpu.py).

- K5's z recompute runs on the weights and bias with their columns permuted
  within each column tile (`ucdir_tpu_torch/ops/akgm.py` `tile_columns`): a
  consumer thread of `csrc/igemm_pc.cuh` holds two groups of 4 columns half a
  tile apart, and those must be one channel's 8 candidates. The permutation
  stays inside a tile (so inside a group), its inverse is exact, and the plain
  grouped product on permuted weights, un-permuted, is `akgm_block_tail_plain`
  and gives its backward.
- The weight gradients reduce per-chunk partials from a workspace whose
  plan (`ops/conv.py` `wgrad_splits`) must hold its cap at every SID train
  shape at batch 32: the sites are recorded from the full-width SID model's
  backward at a small crop and scaled to crop 256.

Tolerance: the permuted product is the same sums in the same order, exact;
the gradients through it 1e-6 abs (float32, the same ops on permuted
operands).
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ucdir_tpu_torch.configs import SID_MODEL
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.ops import akgm, conv
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.train import step_loss

G = 8


def tile_col(bn, tn, j):
    """Column j of consumer thread tn in a tile of 8-column threads
    (igemm_pc.cuh tile_col: two groups of 4, bn / 2 apart)."""
    return (j // 4) * (bn // 2) + tn * 4 + j % 4


@pytest.mark.parametrize('C', [64, 128, 256, 512])
def test_tile_columns_is_a_permutation_within_tiles(C):
    bn = akgm.tail_tile(C)[1]
    assert bn <= C and C % bn == 0          # a tile lies in one group
    cols = akgm.tile_columns(C * G, bn)
    assert torch.equal(torch.sort(cols).values, torch.arange(C * G))
    assert torch.equal(cols // bn, torch.arange(C * G) // bn)
    inv = torch.argsort(cols)
    assert torch.equal(cols[inv], torch.arange(C * G))
    assert torch.equal(inv[cols], torch.arange(C * G))
    # a thread's physical columns are one channel's candidates 0..7
    for tile in range(C * G // bn):
        for tn in range(bn // G):
            phys = [tile * bn + tile_col(bn, tn, j) for j in range(G)]
            assert cols[phys].tolist() == [tile * bn + tn * G + j
                                           for j in range(G)]


def permuted_tail(h, att, w, bias, res, *, norm_scale, norm_shift, attw):
    """The block tail from the grouped product on permuted weights and bias,
    its candidates un-permuted before the mix."""
    B, H, W, C = h.shape
    cols = akgm.tile_columns(C * G, akgm.tail_tile(C)[1])
    wp, bp = w[:, cols], bias[cols]
    hh = h * norm_scale[:, None, None, :] + norm_shift[:, None, None, :]
    k = wp.reshape(3, 3, C // G, C * G).permute(3, 2, 0, 1)
    zp = F.conv2d(hh.permute(0, 3, 1, 2), k, bp, padding=1, groups=G)
    z = zp.permute(0, 2, 3, 1)[..., torch.argsort(cols)]
    A = att * attw[:, None, None, :]
    o = torch.einsum('bhwcj,bhwj->bhwc', z.reshape(B, H, W, C, G), A)
    return conv.swish(o) + res


@pytest.mark.parametrize('C', [64, 128])
def test_permuted_grouped_product_is_the_tail_and_its_backward(C):
    rng = np.random.default_rng(C)
    B, H, W = 2, 5, 6

    def t(*shape, scale=1.0, off=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale + off).astype(np.float32))

    h, res, go = t(B, H, W, C, scale=0.5), t(B, H, W, C), t(B, H, W, C)
    att, attw = t(B, H, W, G, scale=0.5), t(B, G, scale=0.3, off=1.0)
    w = t(9 * C // G, C * G, scale=(9 * C / G) ** -0.5)
    bias = t(C * G, scale=0.1)
    ns, nt = t(B, C, scale=0.2, off=1.0), t(B, C, scale=0.2)
    kw = dict(norm_scale=ns, norm_shift=nt, attw=attw)
    leaves = [v.requires_grad_() for v in (h, att, w, bias, attw)]
    got = permuted_tail(h, att, w, bias, res, **kw)
    want = akgm.akgm_block_tail_plain(h, att, w, bias, res, G, **kw)
    assert torch.equal(got, want)
    dh, datt, dw, dbias, dattw = torch.autograd.grad(got, leaves, go)
    with torch.no_grad():
        p = akgm.akgm_block_tail_backward_plain(
            h, att, w, bias, go, G, norm_scale=ns, norm_shift=nt, attw=attw)
    for g, v in ((dh, p[0] * ns[:, None, None, :]), (datt, p[1]),
                 (dw, p[2]), (dbias, p[3]), (dattw, p[4])):
        assert (g - v).abs().max().item() <= 1e-6 * max(
            1.0, v.abs().max().item())


def sid_train_sites():
    """(kind, H, W, cin, cout) of every K6 call and (kind, H, W, C) of every
    K5 call in one backward of the full-width SID model, at crop 32 (64 x 64
    in the network); the train crop 256 is 288 x 288 in the network."""
    sites = set()
    o6, o5 = conv.conv3x3_backward, akgm.akgm_block_tail_backward

    def r6(x, w, *a, **k):
        sites.add(('k6',) + tuple(x.shape[1:]) + (w.shape[1],))
        return o6(x, w, *a, **k)

    def r5(h, *a, **k):
        sites.add(('k5',) + tuple(h.shape[1:]))
        return o5(h, *a, **k)

    torch.manual_seed(0)
    model = define_G({'model': copy.deepcopy(SID_MODEL)})
    sched = make_schedule(SID_MODEL['beta_schedule']['train'], 'cpu')
    hr = torch.rand(1, 32, 32, 3) * 2 - 1
    conv.conv3x3_backward, akgm.akgm_block_tail_backward = r6, r5
    try:
        step_loss(model, sched, {'HR': hr, 'SR': 0.2 * hr},
                  torch.Generator().manual_seed(0)).backward()
    finally:
        conv.conv3x3_backward, akgm.akgm_block_tail_backward = o6, o5
    return sorted(sites)


def test_wgrad_plan_fits_its_cap_at_the_sid_train_shapes():
    sites = sid_train_sites()
    assert {s[0] for s in sites} == {'k5', 'k6'} and len(sites) >= 20
    batch = 32
    for site in sites:
        H = W = site[1] * 9 // 2   # 288 x 288 is 4.5x 64 x 64
        if site[0] == 'k6':
            cin, cout = site[3], site[4]
            K, N, cols = 9 * cin, cout, cout
        else:
            C = site[3]
            K, N, cols = 9 * C // G, C * G, C
        npix = batch * H * W
        s = conv.wgrad_splits(K, N, cols, npix)
        bm, bn, per_sm = conv.wgrad_tile(cols, K)
        tiles = -(-K // bm) * -(-N // bn)
        assert s >= 1 and s * (K + 1) * N * 4 <= conv.WGRAD_CAP_BYTES, site
        assert npix / s >= conv.WGRAD_MIN_CHUNK, site
        # the grid fills the card: 90% of its block slots in its last wave,
        # unless the cap or the least chunk stops S first
        blocks, slots = tiles * s, 132 * per_sm
        full = blocks >= 0.9 * slots * -(-blocks // slots)
        assert full or s == min(
            conv.WGRAD_CAP_BYTES // (4 * (K + 1) * N),
            -(-npix // conv.WGRAD_MIN_CHUNK)), site


def test_wgrad_splits_follows_the_tile_and_the_card():
    # 7 tiles of 256 x 64 (9 * 192 = 1728 rows, 64 columns): 17 chunks
    # fill 119 of 132 SMs
    assert conv.wgrad_splits(1728, 64, 64, 32 * 288 * 288) == 17
    assert conv.wgrad_splits(1728, 64, 64, 32 * 288 * 288, sms=14) == 2
    # 72 x 4 tiles of 128 x 128 (the 1024 -> 512 conv): 3 chunks, 864
    # blocks in 7 waves, within the cap
    assert conv.wgrad_splits(9216, 512, 512, 32 * 36 * 36) == 3
    # a small image: the least chunk bounds S
    assert conv.wgrad_splits(54, 64, 64, 1000) == 4
