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
  backward at a small crop and scaled to crop 256. K5's weight-gradient tile
  (`wgrad_tile`, as `launch_wgrad` chooses it) lies in one group at every
  width K5 takes, and K6's (one group) is chosen by width as before.
- The bf16 forms run on the tensor cores (`csrc/igemm_tc.cuh`): their weight
  gradient's plan (128-row tiles of dW, 128 (K6) or 64 columns of one
  group, K6's bias a row of the product, 64-pixel slices) holds the cap at
  every SID
  train site; its rows are the im2col side, the wider one but at K6's
  downs_0 (a tie in tiles there); K5's mix epilogue needs no column
  permutation
  (a channel's 8 candidates are one 8-column slab of wgmma's accumulator);
  dattw's workspace counts 8 x 16 pixel tiles.
- K9's staging (`csrc/igemm_pc.cuh`, `AttScaled`) takes the input group of
  each staged channel by additions as a producer's column advances slice by
  slice; mirrored here, it is c // (C / 8) at every tap and channel.

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


@pytest.mark.parametrize('C', [8, 24, 64, 128, 192])
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
        bm, bn, per_sm = conv.wgrad_tile(cols, K, N)
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


def test_tc_wgrad_plan_fits_its_cap_at_the_sid_train_shapes():
    """The bf16 forms' weight gradient on the tensor cores (`csrc/igemm_tc.cuh`
    wgrad_tc_kernel): 128 rows of dW by 128 (K6 from 128 columns) or 64
    columns, K6's bias a row of the product (K + 1 rows), chunks of a
    multiple of 64 pixels; its
    workspace holds the cap at every SID train site at batch 32 and its grid
    fills the card unless the cap or the least chunk stops S first."""
    batch = 32
    for site in sid_train_sites():
        H = W = site[1] * 9 // 2
        k6 = site[0] == 'k6'
        if k6:
            K, N, cols = 9 * site[3], site[4], site[4]
        else:
            K, N, cols = 9 * site[3] // G, site[3] * G, site[3]
        npix = batch * H * W
        s = conv.wgrad_splits(K, N, cols, npix, tensor_cores=True, ones=k6)
        assert s * (K + 1) * N * 4 <= conv.WGRAD_CAP_BYTES, site
        assert npix / s >= conv.WGRAD_MIN_CHUNK, site
        blocks = conv.wgrad_tiles(K, N, cols, True, k6) * s
        full = blocks >= 0.9 * 132 * -(-blocks // 132)
        assert full or s == min(
            conv.WGRAD_CAP_BYTES // (4 * (K + 1) * N),
            -(-npix // conv.WGRAD_MIN_CHUNK)), site


def tc_tiles(M, N, cols, bn=None):
    """Tiles of a tensor-core product of M rows (128 a tile) and N columns
    in groups of `cols` (bn columns a tile; by default 128 for one group of
    128 or more, else 64; min(bn, cols) of one group)."""
    bn = bn or (128 if cols >= max(N, 128) else 64)
    return -(-M // 128) * (N // cols) * -(-cols // min(bn, cols))


@pytest.mark.parametrize('C', [8, 16, 24, 32, 48, 64, 96, 128, 192, 256,
                               512])
def test_tc_wgrad_tiles_lie_in_one_group_and_rows_are_the_wider_side(C):
    """K5's weight gradient at every width it takes, and K6's at every
    width of the SID train sites: each column tile lies in one group and the
    group's columns are covered once; and the product's rows (M, 128 a tile)
    are dW's rows, the im2col side, the wider one (K5: 9 C / 8 against a
    group's C columns; K6: 9 cin + 1 against cout) but at K6's downs_0 (55
    rows against 64 columns), where dW transposed would take as many tiles
    (one)."""
    K, N = 9 * C // G, C * G
    bm, bn, per_sm = conv.wgrad_tile(C, K, N, tensor_cores=True)
    assert (bm, bn, per_sm) == (128, 64, 1)
    assert conv.wgrad_tile(C * G, K, C * G, tensor_cores=True)[1] == (
        128 if C * G >= 128 else 64)   # K6: one group of C * G columns
    width = min(bn, C)
    for g in range(G):
        cover = []
        for t in range(-(-C // width)):
            n0 = g * C + t * width
            n1 = min(n0 + width, (g + 1) * C)
            assert g * C <= n0 < n1 <= (g + 1) * C
            cover += range(n0, n1)
        assert cover == list(range(g * C, (g + 1) * C))
    assert K >= C
    m = conv.tc_merge(C // G)
    assert (m * C // G) % 8 == 0 and m in (1, 2, 4, 8)
    assert conv.wgrad_tiles(K, N, C, True) == tc_tiles(m * K, N, m * C, 64)
    for cin, cout in ((6, 64), (64, 3), (64, 64), (192, 64), (384, 128),
                      (1024, 512), (128, 512), (512, 512)):
        Kc = 9 * cin + 1
        assert conv.wgrad_tiles(9 * cin, cout, cout, True, True) == (
            tc_tiles(Kc, cout, cout))
        assert Kc >= cout or tc_tiles(Kc, cout, cout) == tc_tiles(
            cout, Kc, Kc) == 1, cin


def tc_slab_columns(n, lane):
    """The (channel, candidate) pairs of the grouped product's natural
    columns c * G + j that a lane holds in wgmma's m64nNk16 accumulator
    (`csrc/igemm_tc.cuh` MixEpi), slab by slab: columns 8 s + 2 (lane % 4)
    and + 1 of each 8-column slab s of an n-column tile."""
    return [((8 * s + 2 * (lane % 4) + e) // 8,
             (8 * s + 2 * (lane % 4) + e) % 8)
            for s in range(n // 8) for e in (0, 1)]


@pytest.mark.parametrize('C', [8, 16, 24, 32, 64, 128, 192, 512])
def test_tc_mix_needs_no_column_permutation(C):
    """On the tensor cores a lane of wgmma's m64nNk16 accumulator holds
    columns 8 s + 2 (lane % 4) and + 1 of each 8-column slab s, and in the
    natural column order c * 8 + j a slab is one channel's 8 candidates, 2
    to each lane of a quad: K5's mix epilogue takes the weights and the bias
    as they are (`permuted_columns` is the FMA core's, whose thread holds
    two groups of 4 columns half a tile apart)."""
    for bn in (8, 16, 32, 64):
        if bn > C * G:
            continue
        for lane in range(32):
            got = tc_slab_columns(bn, lane)
            assert len(got) == bn // 4
            for s in range(bn // 8):
                (c0, j0), (c1, j1) = got[2 * s], got[2 * s + 1]
                assert c0 == c1 == s and (j0, j1) == (2 * (lane % 4),
                                                      2 * (lane % 4) + 1)
            quad = [tc_slab_columns(bn, 4 * (lane // 4) + i)
                    for i in range(4)]
            for s in range(bn // 8):
                assert sorted(j for q in quad for c, j in q[2 * s:2 * s + 2]
                              if c == s) == list(range(8))
    # the FMA core's order is another one: the tensor cores' path drops it
    bn = akgm.tail_tile(C)[1]
    assert not torch.equal(akgm.tile_columns(C * G, bn),
                           torch.arange(C * G)) or bn == 8


@pytest.mark.parametrize('C', [8, 16, 24, 32, 40, 96, 64, 512])
def test_tc_merged_weights_are_the_grouped_conv(C):
    """Below 8 channels a group, K5's z recompute on the tensor cores merges
    `tc_merge` groups into one with block-diagonal weights: the grouped conv
    with the merged groups is the grouped conv with the groups (exact: the
    added products are zeros)."""
    rng = np.random.default_rng(C)
    cg, m = C // G, conv.tc_merge(C // G)
    h = torch.from_numpy(rng.standard_normal((1, 6, 7, C)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((9 * cg, C * G))
                         .astype(np.float32))
    wm = akgm.tc_merged_weights(w, G)
    assert wm.shape == (9 * m * cg, C * G)
    want = F.conv2d(h.permute(0, 3, 1, 2),
                    w.reshape(3, 3, cg, C * G).permute(3, 2, 0, 1),
                    padding=1, groups=G)
    got = F.conv2d(h.permute(0, 3, 1, 2),
                   wm.reshape(3, 3, m * cg, C * G).permute(3, 2, 0, 1),
                   padding=1, groups=G // m)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('H,W,want', [(288, 288, 36 * 18), (18, 18, 3 * 2),
                                      (7, 9, 1), (37, 29, 5 * 2)])
def test_tc_dattw_workspace_counts_8_by_16_pixel_tiles(H, W, want):
    assert akgm.tc_pixel_tiles(H, W) == want


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


def test_wgrad_tile_lies_in_one_group_at_every_width():
    """K5's weight gradient (N = 8 C columns in groups of C) runs on a tile
    whose columns divide C from C = 8 to 512: 128 where C % 128 == 0, 64
    where C % 64 == 0 (by K), else 32, 16 or 8 (64 rows up to K = 64, 128
    above). K6 (one group of N = cout) keeps its tile by width."""
    for C in range(8, 513, 8):
        K = 9 * C // G
        bm, bn, _ = conv.wgrad_tile(C, K, C * G)
        assert C % bn == 0, C
        assert bn == (128 if C % 128 == 0 else 64 if C % 64 == 0 else
                      next(b for b in (32, 16, 8) if C % b == 0)), C
        if bn == 64:
            assert bm == (64 if K <= 64 else 96 if K <= 96 else 256)
        elif bn < 64:
            assert bm == (64 if K <= 64 else 128)
    for cout, K, want in ((3, 576, (128, 8)), (64, 54, (64, 64)),
                          (64, 1728, (256, 64)), (130, 630, (128, 128)),
                          (192, 3456, (128, 128)), (512, 9216, (128, 128))):
        assert conv.wgrad_tile(cout, K, cout)[:2] == want, cout


def packed_groups(C, BK=16, KG=4):
    """The input group of every k a K9 producer stages, as the kernel
    advances it (`load_slice` and `produce`, AttScaled): a producer's first
    column 4 * kg, its tap, channel, group and place in the group set once
    by division, then per slice the groups of its 4 channels by a running
    count and the column BK further by additions. Returns {k: group}."""
    cg = C // G
    got = {}
    for kg in range(KG):
        tap, ci = divmod(4 * kg, C)
        grp, gc = divmod(ci, cg)
        for sl in range(-(-9 * C // BK)):
            gv, cv = grp, gc
            for j in range(4):
                if tap < 9:
                    k = tap * C + ci + j
                    assert k == sl * BK + 4 * kg + j
                    got[k] = gv
                cv += 1
                if cv == cg:
                    cv, gv = 0, gv + 1
            gc += BK
            while gc >= cg:
                gc, grp = gc - cg, grp + 1
            ci += BK
            while ci >= C:
                ci, tap, grp = ci - C, tap + 1, grp - G
    return got


@pytest.mark.parametrize('C', [8, 16, 24, 32, 40, 56, 64, 96, 128, 192, 512])
def test_packed_staging_groups_by_additions_are_c_over_cg(C):
    got = packed_groups(C)
    assert sorted(got) == list(range(9 * C))
    assert all(g == (k % C) // (C // G) for k, g in got.items())
