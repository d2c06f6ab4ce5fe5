"""The orders of K1 in bf16 on the tensor cores and of K4's bf16 sums,
emulated in plain PyTorch on the CPU (the kernels need the card:
tests/test_torch_port_gpu.py), and held against the bf16 plain versions,
which tests/test_torch_port_bf16.py holds against the Pallas kernels.

- K1 in bf16 (`csrc/akgm_tail.cu` `tail_tc`, `csrc/igemm_tc.cuh` `TailEpi`):
  the grouped product on `tc_merged_weights` in natural column order (groups
  merged below 8 channels and until one fills the 128-column tile,
  `k1_tc_merge`), k walked in the producers' 64-deep slices and summed in
  k16 chunks into a float32 running sum (how the tensor core adds a
  chunk's products is its own: the chunk's sum taken in float64 here, as
  tests/test_torch_port_tc.py bounds the reordering), then per
  channel z + bias and A = att * attw each rounded, z * A rounded, the 8
  terms added as a quad adds them, ((m0 + m1) + (m2 + m3)) + ((m4 + m5) +
  (m6 + m7)), swish and the residual, rounded once: within one bf16 ulp of
  max(1, |out|) of `akgm_block_tail_plain` and at least 99% the same bits,
  the limits of the GPU tests.
- Its statistics plan: 8 x 16 pixel tiles (rows outside the image add
  nothing), a lane's 2 rows (pixel columns q and q + 8 of warp w's pixel
  row), the warp's 8 quads by shuffles xor 4, 8, 16, the 8 warps in order,
  then `stats_reduce_kernel`'s 32 runs of tiles: `gn1_stats_plain` of the
  rounded output within float32 reordering, 1e-5 of the largest sum of
  squares.
- `tc_merged_weights` in natural columns as K1's forward: in float32 the
  grouped conv on merged groups followed by the mix is the plain tail,
  1e-5 of max(1, |out|).
- K4's bf16 slab plan (`csrc/gn1_stats.cu`, `ops/stats.py` `gn1_slab`):
  every (pixel, 8-channel chunk) in one thread's rows once, each thread's
  rows ascending, the slabs ascending; its sums are `gn1_stats_plain`'s
  within float32 reordering.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ucdir_tpu_torch.ops import akgm, conv, stats

G = 8
BF = torch.bfloat16


def r16(v):
    return v.to(BF).float()


def reduce_runs(ntp):
    """stats_reduce_kernel's order: warp w adds tiles [w run, (w + 1) run),
    run = ceil(ntp / 32), ascending; then the 32 runs in ascending order."""
    run = -(-ntp // 32)
    return [list(range(w * run, min(ntp, (w + 1) * run))) for w in range(32)]


def reduce_tiles(ws):
    """(B, tiles, C) partial sums added in reduce_runs' order."""
    total = torch.zeros(ws.shape[0], ws.shape[2])
    for run in reduce_runs(ws.shape[1]):
        part = torch.zeros_like(total)
        for t in run:
            part = part + ws[:, t]
        total = total + part
    return total


def operands(seed, B, H, W, C, fold, dtype=BF):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, off=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + off)
                                .astype(np.float32)).to(dtype)
    d = dict(h=rnd(B, H, W, C, scale=0.5), att=rnd(B, H, W, G, scale=0.5),
             w=rnd(9 * C // G, C * G, scale=(9 * C / G) ** -0.5),
             bias=rnd(C * G, scale=0.1), res=rnd(B, H, W, C, scale=0.5))
    kw = dict(attw=rnd(B, G, scale=0.3, off=1.0))
    if fold:
        kw.update(norm_scale=rnd(B, C, scale=0.2, off=1.0),
                  norm_shift=rnd(B, C, scale=0.2))
    return d, kw


def slices(cin):
    """The k of each 64-deep slice of the grouped product of `cin` channels a
    group (k = tap * cin + ci): 64 flat k at cin <= 64, else chunk c of 64
    channels, tap inner."""
    K = 9 * cin
    if cin <= 64:
        return [list(range(s, min(K, s + 64))) for s in range(0, K, 64)]
    return [[tap * cin + ci for ci in range(64 * c, min(cin, 64 * c + 64))]
            for c in range(-(-cin // 64)) for tap in range(9)]


def tc_z(hs, wm, bias, C):
    """z (P, C * G) of the merged grouped product: per merged group the
    im2col rows times its columns, k in slice order, each k16 chunk's sum in
    float64 rounded once into the float32 running sum, then + bias."""
    B, H, W, _ = hs.shape
    cin = wm.shape[0] // 9
    ngr = C // cin                       # merged groups
    xp = F.pad(hs, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([xp[:, ty:ty + H, tx:tx + W] for ty in range(3)
                        for tx in range(3)], dim=3)      # (B, H, W, 9, C)
    z = []
    for g in range(ngr):
        a = taps[..., g * cin:(g + 1) * cin].reshape(B * H * W, 9 * cin)
        cols = wm[:, g * (C * G // ngr):(g + 1) * (C * G // ngr)]
        acc = torch.zeros(a.shape[0], cols.shape[1])
        order = [k for ks in slices(cin) for k in ks]
        for i in range(0, len(order), 16):
            ks = order[i:i + 16]
            acc = acc + (a[:, ks].double() @ cols[ks].double()).float()
        z.append(acc)
    return torch.cat(z, dim=1) + bias


def k1_tc(d, kw, C):
    """K1 in bf16 as the tensor-core kernel orders it; (B, H, W, C) float32
    of bf16 values."""
    h = d['h']
    B, H, W, _ = h.shape
    hs = (h.float() if 'norm_scale' not in kw else
          conv.staged_affine(h, kw['norm_scale'], kw['norm_shift']))
    wm = akgm.tc_merged_weights(d['w'], G, akgm.k1_tc_merge(C)).float()
    z5 = tc_z(hs, wm, d['bias'].float(), C).reshape(B, H, W, C, G)
    A = r16(d['att'].float() * kw['attw'].float()[:, None, None, :])
    m = r16(r16(z5) * A[:, :, :, None, :])
    pairs = [m[..., 2 * i] + m[..., 2 * i + 1] for i in range(4)]
    o = (pairs[0] + pairs[1]) + (pairs[2] + pairs[3])
    return r16(conv.swish(o) + d['res'].float())


@pytest.mark.parametrize('C', [8, 24, 64, 128])
@pytest.mark.parametrize('fold', [False, True])
def test_k1_tc_order_meets_the_bf16_limits(C, fold):
    d, kw = operands(C + fold, 2, 11, 19, C, fold)
    got = k1_tc(d, kw, C)
    want = akgm.akgm_block_tail_plain(d['h'], d['att'], d['w'], d['bias'],
                                      d['res'], G, **kw).float()
    assert (got - want).abs().max().item() <= 2. ** -7 * max(
        1.0, want.abs().max().item())
    assert (got == want).float().mean().item() >= 0.99


def tc_tile_sums(out):
    """K1's bf16 statistics plan on (B, H, W, C) values: the (B, tiles, C)
    sums and sums of squares of 8 x 16 pixel tiles, tile ty * ntx + tx, as
    TailEpi adds them."""
    B, H, W, C = out.shape
    nty, ntx = -(-H // 8), -(-W // 16)
    x = F.pad(out, (0, 0, 0, ntx * 16 - W, 0, nty * 8 - H))  # outside: 0
    x = x.reshape(B, nty, 8, ntx, 16, C).permute(0, 1, 3, 2, 4, 5)
    res = []
    for v in (x, x * x):
        lane = v[..., :8, :] + v[..., 8:, :]    # quad q: columns q, q + 8
        for _ in range(3):                      # shuffles xor 4, 8, 16
            lane = lane[..., 0::2, :] + lane[..., 1::2, :]
        warp = lane[..., 0, :]                  # (B, nty, ntx, 8 warps, C)
        tot = torch.zeros(B, nty, ntx, C)
        for w in range(8):
            tot = tot + warp[..., w, :]
        res.append(tot.reshape(B, nty * ntx, C))
    return res


@pytest.mark.parametrize('B,H,W,C', [(2, 13, 21, 8), (1, 19, 37, 24),
                                     (1, 9, 17, 64), (3, 8, 16, 16),
                                     (1, 195, 283, 8)])
def test_k1_tc_statistics_plan_reproduces_gn1_stats(B, H, W, C):
    rng = np.random.default_rng(H * W)
    out = r16(torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32) + 0.5))
    ws_s, ws_q = tc_tile_sums(out)
    assert ws_s.shape[1] == akgm.tc_pixel_tiles(H, W)
    s, q = reduce_tiles(ws_s), reduce_tiles(ws_q)
    want_s, want_q = stats.gn1_stats_plain(out.to(BF))
    scale = want_q.abs().max().item()
    assert (s - want_s).abs().max().item() <= 1e-5 * scale
    assert (q - want_q).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize('C', [8, 24, 64, 128])
@pytest.mark.parametrize('fold', [False, True])
def test_tc_merged_weights_in_natural_columns_are_k1s_forward(C, fold):
    d, kw = operands(100 + C, 1, 6, 9, C, fold, dtype=torch.float32)
    m = akgm.k1_tc_merge(C)
    assert m * C >= min(128, G * C) and (m * C // G) % 8 == 0
    wm = akgm.tc_merged_weights(d['w'], G, m)
    assert wm.shape == (9 * m * (C // G), C * G)
    h = d['h']
    if fold:
        h = (h * kw['norm_scale'][:, None, None, :]
             + kw['norm_shift'][:, None, None, :])
    k = wm.reshape(3, 3, m * C // G, C * G).permute(3, 2, 0, 1)
    z = F.conv2d(h.permute(0, 3, 1, 2), k, d['bias'], padding=1,
                 groups=G // m).permute(0, 2, 3, 1)
    # natural columns: channel c's candidates are columns 8 c .. 8 c + 7
    z5 = z.reshape(*z.shape[:3], C, G)
    A = d['att'] * kw['attw'][:, None, None, :]
    got = conv.swish((z5 * A[:, :, :, None, :]).sum(-1)) + d['res']
    want = akgm.akgm_block_tail_plain(d['h'], d['att'], d['w'], d['bias'],
                                      d['res'], G, **kw)
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())


def k4_plan(P, C):
    """K4's bf16 plan: per (slab, chunk block) the rows each thread adds, as
    {(thread's chunk k, row r): [pixels]} in the thread's order."""
    nk = min(-(-C // 8), 32)
    R, slab = 256 // nk, stats.gn1_slab(C)
    assert slab == R * 32
    plan = []
    for i in range(-(-P // slab)):
        p0, p1 = i * slab, min(P, (i + 1) * slab)
        for y in range(-(-(-(-C // 8)) // nk)):
            for t in range(256):
                k, r = t % nk, t // nk
                chunk = y * nk + k
                if r >= R or 8 * chunk >= C:
                    continue
                plan.append((i, chunk, r, list(range(p0 + r, p1, R))))
    return plan, R, slab


@pytest.mark.parametrize('P,C', [(1000, 8), (4097, 40), (5000, 1024),
                                 (600, 37), (700, 320)])
def test_k4_slab_plan_takes_each_pixel_once_in_ascending_order(P, C):
    plan, R, slab = k4_plan(P, C)
    seen = {}
    for i, chunk, r, pix in plan:
        assert pix == sorted(pix) and all(i * slab <= p < (i + 1) * slab
                                          for p in pix)
        for p in pix:
            assert (p, chunk) not in seen
            seen[(p, chunk)] = i
    assert len(seen) == P * -(-C // 8)


@pytest.mark.parametrize('B,P,C', [(2, 1000, 8), (1, 4097, 40),
                                   (1, 600, 37), (2, 700, 320)])
def test_k4_slab_sums_reproduce_gn1_stats(B, P, C):
    rng = np.random.default_rng(P + C)
    x = r16(torch.from_numpy(rng.standard_normal((B, P, C)).astype(
        np.float32) + 0.3))
    nk = min(-(-C // 8), 32)
    R, slab = 256 // nk, stats.gn1_slab(C)
    slabs = -(-P // slab)
    xp = F.pad(x, (0, 0, 0, slabs * slab - P)).reshape(B, slabs, 32, R, C)
    ws = []
    for v in (xp, xp * xp):
        thread = torch.zeros(B, slabs, R, C)
        for n in range(32):            # a thread's rows r, r + R, ...
            thread = thread + v[:, :, n]
        block = torch.zeros(B, slabs, C)
        for r in range(R):             # the rows in the threads' order
            block = block + thread[:, :, r]
        ws.append(block)
    s, q = reduce_tiles(ws[0]), reduce_tiles(ws[1])
    want_s, want_q = stats.gn1_stats_plain(x.to(BF).reshape(B, 1, P, C))
    scale = want_q.abs().max().item()
    assert (s - want_s).abs().max().item() <= 1e-5 * scale
    assert (q - want_q).abs().max().item() <= 1e-5 * scale
