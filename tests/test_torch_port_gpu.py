"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (partial tiles, odd sizes, B = 2, several
channel tiles). Marked `gpu`: skipped where CUDA is unavailable.

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q   # H100

(--noconftest: tests/conftest.py imports JAX, which the card machine need
not have.)

Tolerance: float32 on both sides, 1e-4 of max(1, |reference|) for tensors
and 1e-5 of the largest sum of squares for the (B, C) statistics, which
the kernels add in another order than the plain versions (K2, K3 and K4
with atomics). The backward kernels K5 and K6
add their weight and bias gradients per chunk of pixels in a fixed order
(the same bits in two calls), and K5 its attention gradients per pixel tile
in a fixed order too: every output of theirs within 1e-4 of max(1, largest
|reference| of that output). K5 takes every C % 8 == 0: its z recompute
runs on K1's tile for C (128 x 128, 256 x 64, 128 by 32, 16 or 8 columns),
its weight gradient on the widest tile whose columns divide C, its input
gradient on tiles of 8, 16, 32 and 64 columns; its cases include C = 8, 16,
24, 32, 96 and 192. K6's run on the tiles of K2.
K7, K8 and K9 (the pre-activated conv, the mix alone, the packed tail) are
held to the same 1e-4 at small and ragged shapes and at the shapes of the
validation path: one 1568 x 2272 frame and its levels, one 1024 x 1024 tile.
K1 and K8 run on tiles of 128 x 128 (C % 128 == 0), 256 x 64 (C % 64 ==
0) and 128 pixels by 32, 16 or 8 columns (other multiples of 8): their
cases and K9's include C = 8, 16, 24, 32 and 192. K1 adds its statistics
without atomics: they are held to the same bits in a second call.
K2 and K3 run on tiles of 128 pixels by 128 or 8 columns, or 256 by 64, in k
slices of 16: their cases include cout 3, 8, 9 and 130, cin 4, 6 and 70, P
one short of and one past a pixel tile, stride 2 on odd sizes and B = 3.
The bf16 forms of K1, K2, K3, K4 and K7 (`_bf16` tests) take the same cases
in bfloat16 against the bf16 plain versions. K1 in bf16 runs on the tensor
cores on K5's grouped product (groups below 8 channels merged: C = 8, 16,
24, 32; the 64- and 128-column tiles; ragged 195 x 283), its statistics and
K4's bf16 sums added in a fixed order (the same bits in a second call; K4
also at C % 8 != 0 and from a misaligned pointer, its scalar loads); K2, K3
and K7 in bf16 run on
the tensor-core core (`csrc/igemm_tc.cuh`: wgmma, tiles of 8 x 16 pixels for
the 3x3 convolutions, 128 for the 1x1, by 128, 64 or 8 columns), every
launch of theirs counted through it, and its edges have tests of their own
(`tensor_core` tests: ragged last tiles, cin = 6 and 96, cout = 3, 24, 64,
96 and 512, stride 2 at odd sizes, the packed upsampling, with and without
fold, swish and statistics; K2's statistics, added per pixel tile in a
fixed order, and K3's output the same bits in a second call). Those of K5
and K6, also on the tensor cores, take cases at C = 32, 64, 192 and 512
and the edges (18 x 18, odd sizes, K6 at cin 3 and 6, cout 3 and 512; dW,
dbias and dattw the same bits in a second call, also where the weight
gradient's chunks split images); the plain versions round where the
kernels do: every output within one bf16 ulp of max(1, |reference|), 2^-7
of it, and at least 99% of them the same bits (a float32 sum in another
order next to a rounding boundary flips one ulp; K5's dattw, 8 sums an
image, where one such flip is 1 in 8 and the share means exactness: a
value of it that differs from the plain version's bits counts as the same
where it has the bits of the same roundings evaluated in float64);
statistics, each side's float32
sums of its own rounded output, within the sum over the pixels of the two
outputs' differences (of their squares' differences) and 1e-5 of the
largest sum of squares.
"""
import pytest
import torch

from ucdir_tpu_torch.ops import _build, akgm, conv, stats

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def rnd(gen, *shape, scale=1.0, off=0.0):
    return torch.randn(shape, generator=gen, device=gen.device) * scale + off


def flat(out):
    if isinstance(out, tuple):
        return [t for o in out for t in flat(o)]
    return [out]


def check(got, want, n_stats):
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    qmax = want[-1].abs().max().item() if n_stats else 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        tol = (1e-5 * qmax if i >= len(got) - n_stats
               else 1e-4 * max(1.0, w.abs().max().item()))
        err = (g - w).abs().max().item()
        assert err <= tol, (i, err, tol)


@pytest.mark.parametrize('B,H,W,C', [(2, 13, 21, 64), (1, 9, 130, 128),
                                     (1, 5, 7, 512)])
@pytest.mark.parametrize('fold', [False, True])
def test_akgm_tail(dev, B, H, W, C, fold):
    gen, G = torch.Generator(dev).manual_seed(0), 8
    h, res = rnd(gen, B, H, W, C, scale=0.5), rnd(gen, B, H, W, C, scale=0.5)
    att, aw = rnd(gen, B, H, W, G, scale=0.5), rnd(gen, B, G, off=1.0)
    w = rnd(gen, 9 * C // G, C * G, scale=(9 * C / G) ** -0.5)
    b = rnd(gen, C * G, scale=0.1)
    kw = dict(attw=aw, emit_stats=True)
    if fold:
        kw.update(norm_scale=rnd(gen, B, C, scale=0.2, off=1.0),
                  norm_shift=rnd(gen, B, C, scale=0.2))
    n = _build.LAUNCHES['akgm_tail']
    got = akgm.akgm_block_tail(h, att, w, b, res, G, **kw)
    assert _build.LAUNCHES['akgm_tail'] == n + 1
    check(got, akgm.akgm_block_tail_plain(h, att, w, b, res, G, **kw), 2)


# K1 and K8 on the tiles narrower than 64 columns (128 pixels by the widest
# of 32, 16 and 8 columns that divides C) and on the 256 x 64 tile at C =
# 192; K9 at the same widths
NARROW = [(2, 13, 21, 8), (1, 9, 130, 16), (1, 17, 11, 32), (1, 6, 10, 24),
          (1, 5, 9, 192)]


def tail_operands(gen, B, H, W, C, fold, G=8):
    h, att, w, b = akgm_operands(gen, B, H, W, C)
    res = rnd(gen, B, H, W, C, scale=0.5)
    kw = dict(attw=rnd(gen, B, G, scale=0.3, off=1.0))
    if fold:
        kw.update(norm_scale=rnd(gen, B, C, scale=0.2, off=1.0),
                  norm_shift=rnd(gen, B, C, scale=0.2))
    return h, att, w, b, res, kw


@pytest.mark.parametrize('B,H,W,C', NARROW)
@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('emit_stats', [False, True])
def test_akgm_tail_narrow(dev, B, H, W, C, fold, emit_stats):
    gen, G = torch.Generator(dev).manual_seed(13), 8
    h, att, w, b, res, kw = tail_operands(gen, B, H, W, C, fold)
    n = _build.LAUNCHES['akgm_tail']
    got = akgm.akgm_block_tail(h, att, w, b, res, G, emit_stats=emit_stats,
                               **kw)
    assert _build.LAUNCHES['akgm_tail'] == n + 1
    check(got, akgm.akgm_block_tail_plain(h, att, w, b, res, G,
                                          emit_stats=emit_stats, **kw),
          2 if emit_stats else 0)


@pytest.mark.parametrize('B,H,W,C', [(2, 40, 37, 64), (1, 33, 65, 128),
                                     (3, 9, 13, 8), (1, 7, 300, 512)])
def test_akgm_tail_statistics_repeat_bit_for_bit(dev, B, H, W, C):
    """K1 adds its statistics per pixel tile and then over the tiles in a
    fixed order, with no atomics: a second call gives the same bits, and
    the output itself is the same too."""
    gen, G = torch.Generator(dev).manual_seed(14), 8
    h, att, w, b, res, kw = tail_operands(gen, B, H, W, C, True)
    one = flat(akgm.akgm_block_tail(h, att, w, b, res, G, emit_stats=True,
                                    **kw))
    two = flat(akgm.akgm_block_tail(h, att, w, b, res, G, emit_stats=True,
                                    **kw))
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    check(tuple(one), akgm.akgm_block_tail_plain(
        h, att, w, b, res, G, emit_stats=True, **kw), 2)


CONV3X3_SHAPES = [
    (2, 11, 17, 6, 64, 1), (1, 20, 33, 192, 64, 1), (1, 9, 15, 70, 3, 1),
    (2, 16, 24, 64, 64, 2), (1, 15, 9, 32, 100, 2), (1, 6, 10, 128, 512, 1),
    (1, 127, 1, 4, 8, 1), (1, 3, 43, 70, 9, 1), (3, 7, 9, 6, 130, 1),
    (3, 13, 17, 64, 3, 2), (1, 1, 129, 64, 130, 1), (2, 21, 25, 70, 130, 2),
    (1, 16, 16, 1024, 512, 1)]


def conv3x3_operands(dev, B, H, W, cin, cout, stride, fold_act):
    gen = torch.Generator(dev).manual_seed(1)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    kw = dict(stride=stride, emit_stats=True)
    if fold_act:
        kw.update(act='swish', norm_scale=rnd(gen, B, cin, off=1.0),
                  norm_shift=rnd(gen, B, cin, scale=0.2))
    return x, w, b, kw


@pytest.mark.parametrize('B,H,W,cin,cout,stride', CONV3X3_SHAPES)
@pytest.mark.parametrize('fold_act', [False, True])
def test_conv3x3(dev, B, H, W, cin, cout, stride, fold_act):
    x, w, b, kw = conv3x3_operands(dev, B, H, W, cin, cout, stride, fold_act)
    check(conv.conv3x3(x, w, b, **kw), conv.conv3x3_plain(x, w, b, **kw), 2)


def test_upconv2x_is_upsample_then_conv(dev):
    gen = torch.Generator(dev).manual_seed(2)
    cin, cout = 64, 64
    x = rnd(gen, 1, 7, 12, cin, scale=0.5)
    k = rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    wp = conv.pack_up_kernel(k).reshape(9 * cin, 4 * cout).contiguous()
    got = conv.upconv2x(x, wp, b.repeat(4), emit_stats=True)
    up = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    check(got, conv.conv3x3_plain(up, k.reshape(9 * cin, cout), b,
                                  emit_stats=True), 2)


CONV1X1_SHAPES = [
    (2, 9, 31, 192, 64), (1, 4, 5, 1024, 512), (3, 1, 127, 4, 3),
    (1, 3, 43, 70, 9), (1, 8, 16, 6, 130), (2, 127, 1, 64, 8)]


@pytest.mark.parametrize('B,H,W,cin,cout', CONV1X1_SHAPES)
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv1x1(dev, B, H, W, cin, cout, act):
    gen = torch.Generator(dev).manual_seed(3)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w, b = rnd(gen, cin, cout, scale=cin ** -0.5), rnd(gen, cout, scale=0.1)
    check(conv.conv1x1(x, w, b, act=act),
          conv.conv1x1_plain(x, w, b, act=act), 0)


@pytest.mark.parametrize('shape', [(2, 17, 19, 40), (1, 33, 65, 1024)])
def test_gn1_stats(dev, shape):
    gen = torch.Generator(dev).manual_seed(4)
    x = rnd(gen, *shape, off=0.3)
    check(stats.gn1_stats(x), stats.gn1_stats_plain(x), 2)


@pytest.mark.parametrize('B,H,W,C', [(2, 13, 21, 64), (1, 9, 130, 128),
                                     (2, 18, 18, 512), (1, 40, 50, 256)])
@pytest.mark.parametrize('fold_attw', [False, True])
def test_akgm_tail_backward(dev, B, H, W, C, fold_attw):
    gen, G = torch.Generator(dev).manual_seed(5), 8
    h, go = rnd(gen, B, H, W, C, scale=0.5), rnd(gen, B, H, W, C)
    att = rnd(gen, B, H, W, G, scale=0.5)
    w = rnd(gen, 9 * C // G, C * G, scale=(9 * C / G) ** -0.5)
    b = rnd(gen, C * G, scale=0.1)
    kw = {}
    if fold_attw:
        kw.update(norm_scale=rnd(gen, B, C, scale=0.2, off=1.0),
                  norm_shift=rnd(gen, B, C, scale=0.2),
                  attw=rnd(gen, B, G, scale=0.3, off=1.0))
    n = _build.LAUNCHES['akgm_tail_bwd']
    got = akgm.akgm_block_tail_backward(h, att, w, b, go, G, **kw)
    assert _build.LAUNCHES['akgm_tail_bwd'] == n + 1
    want = akgm.akgm_block_tail_backward_plain(h, att, w, b, go, G, **kw)
    # got: (dh, datt, dw, dbias, dres, dns, dnt, dattw); want: K5's tuple
    check((got[1], got[2], got[3]), (want[1], want[2], want[3]), 0)
    if fold_attw:
        a = kw['norm_scale'][:, None, None, :]
        check((got[0], got[7]), (want[0] * a, want[4]), 0)
    else:
        check(got[0], want[0], 0)
        assert got[5] is None and got[6] is None and got[7] is None


@pytest.mark.parametrize('B,H,W,cin,cout', [
    (2, 11, 17, 6, 64), (1, 20, 33, 192, 64), (1, 9, 15, 70, 3),
    (2, 18, 18, 1024, 512), (1, 6, 10, 128, 512), (1, 64, 80, 64, 64)])
@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv3x3_backward(dev, B, H, W, cin, cout, fold, act):
    gen = torch.Generator(dev).manual_seed(6)
    x, go = rnd(gen, B, H, W, cin, scale=0.5), rnd(gen, B, H, W, cout)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    kw = dict(act=act)
    if fold:
        kw.update(norm_scale=rnd(gen, B, cin, scale=0.2, off=1.0),
                  norm_shift=rnd(gen, B, cin, scale=0.2))
    n = _build.LAUNCHES['conv3x3_bwd']
    got = conv.conv3x3_backward(x, w, b, go, **kw)
    assert _build.LAUNCHES['conv3x3_bwd'] == n + 1
    dxh, dw, db = conv.conv3x3_backward_plain(x, w, b, go, **kw)
    if fold:
        dxh = dxh * kw['norm_scale'][:, None, None, :]
    check(got[:3], (dxh, dw, db), 0)


def _chunks_split_an_image(dev, K, N, cols, B, H, W, tc=False, ones=False):
    """The weight gradient's plan on this card cuts the batch's pixels into
    more than one chunk and some chunk ends inside an image (tc: the tensor
    cores' plan, chunks of a multiple of 64 pixels)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    npix, P = B * H * W, H * W
    s = conv.wgrad_splits(K, N, cols, npix, sms, tensor_cores=tc, ones=ones)
    step = 64 if tc else 16
    chunk = -(-(-(-npix // s)) // step) * step
    return s > 1 and any(q % P for q in range(chunk, npix, chunk))


@pytest.mark.parametrize('kind,shape', [
    ('k6', (2, 37, 29, 64, 64, 'swish')), ('k6', (3, 19, 23, 6, 64, None)),
    ('k6', (2, 21, 17, 192, 3, 'swish')), ('k6', (2, 23, 21, 512, 128, None)),
    ('k5', (2, 31, 27, 64)), ('k5', (3, 17, 19, 128)),
    ('k5', (2, 13, 11, 256)), ('k5', (2, 21, 23, 512)),
    ('k5', (2, 31, 27, 8)), ('k5', (2, 29, 23, 16)), ('k5', (2, 21, 19, 24)),
    ('k5', (2, 25, 23, 32)), ('k5', (2, 17, 15, 96)),
    ('k5', (2, 13, 11, 192))])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_backward_weight_gradients_repeat_bit_for_bit(dev, kind, shape,
                                                      dtype):
    """dW and dbias of K5 and K6 are partial tiles of pixel chunks added in
    a fixed order, K5's datt the sum of a block's column tiles and its dattw
    per pixel tile sums added in a fixed order: two calls give the same
    bits, where the chunks split images and the pixel count is not a
    multiple of the 16-pixel slice. bfloat16: the tensor cores' weight
    gradient (chunks of 64-pixel slices) and K5's datt and dattw there,
    each output within one bf16 ulp of max(1, largest) of the plain
    version's."""
    gen, G = torch.Generator(dev).manual_seed(13), 8
    low = dtype == 'bfloat16'
    cast = (lambda *ts: bf16(*ts)) if low else (lambda *ts: ts)
    if kind == 'k6':
        B, H, W, cin, cout, act = shape
        x, go = rnd(gen, B, H, W, cin, scale=0.5), rnd(gen, B, H, W, cout)
        w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
        b = rnd(gen, cout, scale=0.1)
        a, t = rnd(gen, B, cin, scale=0.2, off=1.0), rnd(gen, B, cin)
        x, go, w, b, a, t = cast(x, go, w, b, a, t)
        assert _chunks_split_an_image(dev, 9 * cin, cout, cout, B, H, W,
                                      tc=low, ones=low)
        run = lambda: conv.conv3x3_backward_kernel(x, w, b, go, act, a, t)
        fixed, want = (1, 2), conv.conv3x3_backward_plain(
            x, w, b, go, act=act, norm_scale=a, norm_shift=t)
    else:
        B, H, W, C = shape
        h, att, w, b = akgm_operands(gen, B, H, W, C)
        go = rnd(gen, B, H, W, C)
        ns, nt = rnd(gen, B, C, scale=0.2, off=1.0), rnd(gen, B, C, scale=0.2)
        aw = rnd(gen, B, G, scale=0.3, off=1.0)
        h, att, w, b, go, ns, nt, aw = cast(h, att, w, b, go, ns, nt, aw)
        assert _chunks_split_an_image(dev, 9 * C // G, C * G, C, B, H, W,
                                      tc=low)
        run = lambda: akgm.akgm_block_tail_backward_kernel(
            h, att, w, b, go, G, ns, nt, aw)
        fixed, want = (1, 2, 3, 4), akgm.akgm_block_tail_backward_plain(
            h, att, w, b, go, G, norm_scale=ns, norm_shift=nt, attw=aw)
    assert (H * W) % 16
    first, second = run(), run()
    if low:
        # one bf16 ulp of max(1, largest); the share of bits kept is
        # test_akgm_tail_backward_bf16's and test_conv3x3_backward_bf16's
        for g, w_ in zip(first, want):
            g, w_ = g.float(), w_.float()
            assert ((g - w_).abs().max() <= 2. ** -7 * max(
                1.0, w_.abs().max().item()))
    else:
        check(first, want, 0)
    for i in fixed:
        assert torch.equal(first[i], second[i]), i


FRAME = (1568, 2272)


PREACT_SHAPES = [
    (1, 18, 18, 64, 3), (2, 11, 17, 64, 3), (1, 9, 15, 70, 24),
    (1, 6, 10, 128, 100), (1, 1024, 1024, 64, 3), (1,) + FRAME + (64, 3)]


@pytest.mark.parametrize('B,H,W,cin,cout', PREACT_SHAPES)
def test_conv3x3_preact(dev, B, H, W, cin, cout):
    gen = torch.Generator(dev).manual_seed(8)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    # shifts down to about -6: values where swish is near 0 and below
    a, t = rnd(gen, B, cin, off=1.0), rnd(gen, B, cin, scale=2.0)
    n = dict(_build.LAUNCHES)
    got = conv.conv3x3_preact(x, w, b, a, t)
    assert _build.LAUNCHES['conv3x3_preact'] == n['conv3x3_preact'] + 1
    assert _build.LAUNCHES['conv3x3'] == n['conv3x3']
    check(got, conv.conv3x3_preact_plain(x, w, b, a, t), 0)


def test_conv3x3_preact_survives_huge_negative_inputs(dev):
    """expf overflows for -(x * a + t) above 88: swish must give 0, not NaN,
    and the output is then the bias alone."""
    gen = torch.Generator(dev).manual_seed(9)
    x = rnd(gen, 1, 9, 13, 64)
    w, b = rnd(gen, 9 * 64, 3, scale=0.05), rnd(gen, 3)
    a = torch.ones(1, 64, device=dev)
    t = torch.full((1, 64), -500., device=dev)
    got = conv.conv3x3_preact(x, w, b, a, t)
    assert torch.isfinite(got).all()
    assert (got - b).abs().max().item() <= 1e-6


def akgm_operands(gen, B, H, W, C, G=8):
    return (rnd(gen, B, H, W, C, scale=0.5), rnd(gen, B, H, W, G, scale=0.5),
            rnd(gen, 9 * C // G, C * G, scale=(9 * C / G) ** -0.5),
            rnd(gen, C * G, scale=0.1))


AKGM_SHAPES = [(2, 13, 21, 64), (1, 18, 18, 512), (1, 9, 130, 128),
               (1, 5, 7, 256), (1,) + FRAME + (64,),
               (1, FRAME[0] // 2, FRAME[1] // 2, 128),
               (1, FRAME[0] // 4, FRAME[1] // 4, 256),
               (1, FRAME[0] // 8, FRAME[1] // 8, 512)]


@pytest.mark.parametrize('B,H,W,C', AKGM_SHAPES)
def test_akgm_mix(dev, B, H, W, C):
    gen, G = torch.Generator(dev).manual_seed(10), 8
    h, att, w, b = akgm_operands(gen, B, H, W, C)
    n = dict(_build.LAUNCHES)
    got = akgm.akgm_mix(h, att, w, b, G)
    assert _build.LAUNCHES['akgm_mix'] == n['akgm_mix'] + 1
    assert _build.LAUNCHES['akgm_tail'] == n['akgm_tail']
    check(got, akgm.akgm_mix_reference(h, att, w, b, G), 0)


@pytest.mark.parametrize('B,H,W,C', AKGM_SHAPES)
@pytest.mark.parametrize('fold_attw', [False, True])
def test_akgm_packed(dev, B, H, W, C, fold_attw):
    gen, G = torch.Generator(dev).manual_seed(11), 8
    h, att, w, b = akgm_operands(gen, B, H, W, C)
    res = rnd(gen, B, H, W, C, scale=0.5)
    wp = akgm.pack_grouped_weight(w, G).contiguous()
    kw = {}
    if fold_attw:
        kw.update(norm_scale=rnd(gen, B, C, scale=0.2, off=1.0),
                  norm_shift=rnd(gen, B, C, scale=0.2),
                  attw=rnd(gen, B, G, scale=0.3, off=1.0))
    n = dict(_build.LAUNCHES)
    got = akgm.akgm_block_tail_packed(h, att, wp, b, res, G, **kw)
    assert _build.LAUNCHES['akgm_packed'] == n['akgm_packed'] + 1
    assert _build.LAUNCHES['akgm_tail'] == n['akgm_tail']
    check(got, akgm.akgm_block_tail_packed_plain(h, att, wp, b, res, G, **kw),
          0)


@pytest.mark.parametrize('B,H,W,C', NARROW)
def test_akgm_mix_narrow(dev, B, H, W, C):
    gen, G = torch.Generator(dev).manual_seed(15), 8
    h, att, w, b = akgm_operands(gen, B, H, W, C)
    n = _build.LAUNCHES['akgm_mix']
    got = akgm.akgm_mix(h, att, w, b, G)
    assert _build.LAUNCHES['akgm_mix'] == n + 1
    check(got, akgm.akgm_mix_reference(h, att, w, b, G), 0)


@pytest.mark.parametrize('B,H,W,C', NARROW)
@pytest.mark.parametrize('fold', [False, True])
def test_akgm_packed_narrow(dev, B, H, W, C, fold):
    gen, G = torch.Generator(dev).manual_seed(16), 8
    h, att, w, b, res, kw = tail_operands(gen, B, H, W, C, fold)
    wp = akgm.pack_grouped_weight(w, G).contiguous()
    n = _build.LAUNCHES['akgm_packed']
    got = akgm.akgm_block_tail_packed(h, att, wp, b, res, G, **kw)
    assert _build.LAUNCHES['akgm_packed'] == n + 1
    check(got, akgm.akgm_block_tail_packed_plain(h, att, wp, b, res, G, **kw),
          0)


@pytest.mark.parametrize('B,H,W,C', NARROW + [(2, 11, 9, 96)])
@pytest.mark.parametrize('fold_attw', [False, True])
def test_akgm_tail_backward_narrow(dev, B, H, W, C, fold_attw):
    """K5 at the widths of narrower models: the narrow tiles of the z
    recompute, weight-gradient tiles that divide C, and the input gradient's
    8-, 16- and 32-column tiles with ragged groups (C / 8 = 1, 2, 3, 4, 12,
    24), against its plain version, every output."""
    gen, G = torch.Generator(dev).manual_seed(17), 8
    h, att, w, b = akgm_operands(gen, B, H, W, C)
    go = rnd(gen, B, H, W, C)
    kw = {}
    if fold_attw:
        kw.update(norm_scale=rnd(gen, B, C, scale=0.2, off=1.0),
                  norm_shift=rnd(gen, B, C, scale=0.2),
                  attw=rnd(gen, B, G, scale=0.3, off=1.0))
    n = _build.LAUNCHES['akgm_tail_bwd']
    got = akgm.akgm_block_tail_backward_kernel(
        h, att, w, b, go, G, kw.get('norm_scale'), kw.get('norm_shift'),
        kw.get('attw'))
    assert _build.LAUNCHES['akgm_tail_bwd'] == n + 1
    want = akgm.akgm_block_tail_backward_plain(h, att, w, b, go, G, **kw)
    if fold_attw:
        check(got, want, 0)
    else:
        assert got[4] is None and want[4] is None
        check(got[:4], want[:4], 0)


def test_new_functions_backward_on_the_card(dev):
    """loss.backward() through conv3x3_preact, akgm_mix and
    akgm_block_tail_packed on the card (forward kernels, plain backward)
    against the plain versions' autograd."""
    gen, G, C = torch.Generator(dev).manual_seed(12), 8, 64
    h, att, w, b = akgm_operands(gen, 2, 12, 10, C)
    res = rnd(gen, 2, 12, 10, C, scale=0.5)
    a, t = rnd(gen, 2, C, scale=0.2, off=1.0), rnd(gen, 2, C, scale=0.2)
    w3, b3 = rnd(gen, 9 * C, 3, scale=0.05), rnd(gen, 3, scale=0.1)
    leaves = [v.requires_grad_() for v in (h, att, w, b, res, a, t, w3, b3)]

    def net(mix, packed, preact):
        y = mix(h, att, w, b, G)
        z = packed(y, att, akgm.pack_grouped_weight(w, G).contiguous(), b,
                   res, G, norm_scale=a, norm_shift=t)
        return (preact(z, w3, b3, a, t) ** 2).mean()

    got = torch.autograd.grad(net(akgm.akgm_mix, akgm.akgm_block_tail_packed,
                                  conv.conv3x3_preact), leaves)
    want = torch.autograd.grad(net(akgm.akgm_mix_reference,
                                   akgm.akgm_block_tail_packed_plain,
                                   conv.conv3x3_preact_plain), leaves)
    for g, v in zip(got, want):
        assert (g - v).abs().max().item() <= 1e-4 * max(
            1.0, v.abs().max().item())


def test_functions_backward_through_the_kernels(dev):
    """loss.backward() through conv3x3, conv1x1, gn1_stats and
    akgm_block_tail on the card against the plain versions' autograd."""
    gen, G, C = torch.Generator(dev).manual_seed(7), 8, 64
    x = rnd(gen, 2, 12, 10, 24, scale=0.5)
    w3 = rnd(gen, 9 * 24, C, scale=0.07)
    w1 = rnd(gen, 24, C, scale=0.2)
    wg = rnd(gen, 9 * C // G, C * G, scale=0.1)
    b3, b1, bg = (rnd(gen, n, scale=0.1) for n in (C, C, C * G))
    att = rnd(gen, 2, 12, 10, G, scale=0.5)
    leaves = [t.requires_grad_() for t in (x, w3, w1, wg, b3, b1, bg, att)]

    def net(c3, c1, st, tail):
        s, q = st(x)
        a = 1.0 / (1.0 + q.mean(1, keepdim=True)) + 0 * s
        h, (hs, hq) = c3(x, w3, b3, act='swish', norm_scale=a,
                         norm_shift=0.1 * s, emit_stats=True)
        out, (os_, oq) = tail(h, att, wg, bg, c1(x, w1, b1), G,
                              norm_scale=1 + 1e-3 * hs, norm_shift=1e-3 * hq,
                              emit_stats=True)
        return (out * out).mean() + os_.mean() + 1e-2 * oq.mean()

    n5, n6 = (_build.LAUNCHES[k] for k in ('akgm_tail_bwd', 'conv3x3_bwd'))
    got = torch.autograd.grad(net(conv.conv3x3, conv.conv1x1,
                                  stats.gn1_stats, akgm.akgm_block_tail),
                              leaves)
    assert _build.LAUNCHES['akgm_tail_bwd'] == n5 + 1
    assert _build.LAUNCHES['conv3x3_bwd'] == n6 + 1
    want = torch.autograd.grad(net(conv.conv3x3_plain, conv.conv1x1_plain,
                                   stats.gn1_stats_plain,
                                   akgm.akgm_block_tail_plain), leaves)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


def test_wrappers_raise_on_bad_operands(dev):
    x = torch.zeros(1, 4, 4, 64, device=dev)
    w, b = torch.zeros(9 * 64, 64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(TypeError, match='float32'):
        conv.conv3x3(x.half(), w, b)
    with pytest.raises(ValueError, match='shape'):
        conv.conv3x3(x, w[:-1], b)
    with pytest.raises(ValueError, match='contiguous'):
        conv.conv3x3(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match='CUDA'):
        conv.conv3x3(x, w.cpu(), b)


# ---- the bf16 forms of K1, K2, K3, K4 and K7
BF = torch.bfloat16


def check_bf16(got, want, n_stats, exact=None):
    """`exact`: {output index: the same output evaluated in float64 with the
    same roundings}, for outputs of a few values (K5's dattw); a value there
    that differs from the plain version's bits agrees where it has the
    float64 evaluation's (the plain version's float32 sum, next to a
    rounding boundary, on the other side of it)."""
    got, want = flat(got), flat(want)
    exact = exact or {}
    assert len(got) == len(want)
    qmax = want[-1].abs().max().item() if n_stats else 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        if i >= len(got) - n_stats:
            # each side's float32 sums of its own rounded output: they
            # differ by what the outputs do (a flipped last bit is a whole
            # bf16 ulp in a sum of a few pixels), summed over the pixels
            assert g.dtype == torch.float32
            slack = 0.
            if len(got) > n_stats:
                o, p = got[0].float(), want[0].float()
                k = i - (len(got) - n_stats)   # 0: sums, 1: sums of squares
                slack = ((o - p) if k == 0 else (o * o - p * p)).abs().sum(
                    dim=(1, 2))
            assert ((g - w).abs() <= slack + 1e-5 * qmax).all(), (i, qmax)
            continue
        assert g.dtype == w.dtype == BF
        g, w = g.float(), w.float()
        err, tol = (g - w).abs().max().item(), 2. ** -7 * max(
            1.0, w.abs().max().item())
        assert err <= tol, (i, err, tol)
        same = g == w
        if i in exact:
            same |= g == exact[i].float()
        assert same.float().mean().item() >= 0.99, i


def bf16(*ts):
    return [None if t is None else t.to(BF) for t in ts]


def akgm_dattw_bf16_exact(h, att, w, bias, go, nset, ns, nt, aw):
    """K5's bf16 dattw as `akgm.akgm_block_tail_backward_plain` rounds it,
    every sum in float64."""
    B, H, W, C = h.shape
    cg, f64 = C // nset, torch.float64

    def r(v):
        return v.to(BF).to(f64)
    hs = (h if ns is None else conv.staged_affine(h, ns, nt)).to(f64)
    A = att.to(f64) * aw.to(f64)[:, None, None, :]
    k = w.to(f64).reshape(3, 3, cg, C * nset).permute(3, 2, 0, 1)
    z = torch.nn.functional.conv2d(hs.permute(0, 3, 1, 2), k, bias.to(f64),
                                   padding=1, groups=nset)
    z5 = z.permute(0, 2, 3, 1).reshape(B, H, W, C, nset)
    m = r(r(z5) * r(A)[:, :, :, None, :])
    do = r(go.to(f64) * conv.dswish(m.sum(dim=-1)))
    q = r(do[..., None] * z5).sum(dim=-2)
    return (q * att.to(f64)).sum(dim=(1, 2)).to(BF)


def launched(name, fn):
    n, tc = dict(_build.LAUNCHES), _build.tc_launches()
    out = fn()
    assert _build.LAUNCHES[name + '_bf16'] == n[name + '_bf16'] + 1
    assert _build.LAUNCHES[name] == n[name]
    # K2, K3, K5, K6 and K7 in bf16 go through the tensor cores, nothing
    # else does
    assert (_build.tc_launches()[name + '_bf16']
            == tc[name + '_bf16'] + (name + '_bf16' in _build.TC_ENTRIES))
    return out


# K1 in bf16 on the tensor cores: the frame's widths, the narrow ones (groups
# merged), and ragged 8 x 16 pixel tiles at the /8 level of the frame
K1_BF16_SHAPES = [(2, 13, 21, 64), (1, 9, 130, 128), (1, 5, 7, 512)] + \
    NARROW + [(1, 195, 283, 64), (1, 195, 283, 24), (1, 195, 283, 256)]


@pytest.mark.parametrize('B,H,W,C', K1_BF16_SHAPES)
@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('emit_stats', [False, True])
def test_akgm_tail_bf16(dev, B, H, W, C, fold, emit_stats):
    """K1 in bf16 against its bf16 plain version; every call through the
    tensor cores (`launched`: 'akgm_tail_bf16' is a TC entry)."""
    assert 'akgm_tail_bf16' in _build.TC_ENTRIES
    gen, G = torch.Generator(dev).manual_seed(15), 8
    h, att, w, b, res, kw = tail_operands(gen, B, H, W, C, fold)
    h, att, w, b, res = bf16(h, att, w, b, res)
    kw = {k: v.to(BF) for k, v in kw.items()}
    got = launched('akgm_tail', lambda: akgm.akgm_block_tail(
        h, att, w, b, res, G, emit_stats=emit_stats, **kw))
    check_bf16(got, akgm.akgm_block_tail_plain(
        h, att, w, b, res, G, emit_stats=emit_stats, **kw),
        2 if emit_stats else 0)


@pytest.mark.parametrize('B,H,W,C', [(2, 40, 37, 64), (1, 33, 65, 128),
                                     (3, 9, 13, 8), (1, 7, 300, 512),
                                     (1, 195, 283, 24)])
def test_akgm_tail_bf16_statistics_repeat_bit_for_bit(dev, B, H, W, C):
    """K1 in bf16 adds its statistics per 8 x 16 pixel tile and then over
    the tiles in a fixed order, with no atomics: a second call gives the
    same bits, and the output itself is the same too."""
    gen, G = torch.Generator(dev).manual_seed(14), 8
    h, att, w, b, res, kw = tail_operands(gen, B, H, W, C, True)
    h, att, w, b, res = bf16(h, att, w, b, res)
    kw = {k: v.to(BF) for k, v in kw.items()}
    one, two = (flat(akgm.akgm_block_tail(h, att, w, b, res, G,
                                          emit_stats=True, **kw))
                for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    check_bf16(tuple(one), akgm.akgm_block_tail_plain(
        h, att, w, b, res, G, emit_stats=True, **kw), 2)


@pytest.mark.parametrize('B,H,W,cin,cout,stride', CONV3X3_SHAPES)
@pytest.mark.parametrize('fold_act', [False, True])
def test_conv3x3_bf16(dev, B, H, W, cin, cout, stride, fold_act):
    x, w, b, kw = conv3x3_operands(dev, B, H, W, cin, cout, stride, fold_act)
    x, w, b = bf16(x, w, b)
    kw = {k: v.to(BF) if torch.is_tensor(v) else v for k, v in kw.items()}
    got = launched('conv3x3', lambda: conv.conv3x3(x, w, b, **kw))
    check_bf16(got, conv.conv3x3_plain(x, w, b, **kw), 2)


def test_upconv2x_bf16(dev):
    gen = torch.Generator(dev).manual_seed(2)
    cin, cout = 64, 64
    x = rnd(gen, 1, 7, 12, cin, scale=0.5).to(BF)
    k = rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(BF)
    b = rnd(gen, cout, scale=0.1).to(BF)
    wp = conv.pack_up_kernel(k).reshape(9 * cin, 4 * cout).contiguous()
    bp = b.repeat(4)
    check_bf16(launched('conv3x3', lambda: conv.upconv2x(x, wp, bp)),
               conv.depth_to_space2(conv.conv3x3_plain(x, wp, bp)), 0)


@pytest.mark.parametrize('B,H,W,cin,cout', CONV1X1_SHAPES)
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv1x1_bf16(dev, B, H, W, cin, cout, act):
    gen = torch.Generator(dev).manual_seed(3)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w, b = rnd(gen, cin, cout, scale=cin ** -0.5), rnd(gen, cout, scale=0.1)
    x, w, b = bf16(x, w, b)
    check_bf16(launched('conv1x1', lambda: conv.conv1x1(x, w, b, act=act)),
               conv.conv1x1_plain(x, w, b, act=act), 0)


# K4 in bf16: 16-byte loads (C % 8 == 0), 5 to 32 chunks of 8 channels a
# block, two channel blocks (C = 1024, 320), and the scalar loads (C = 37)
GN1_BF16_SHAPES = [(2, 17, 19, 40), (1, 33, 65, 1024), (2, 9, 11, 8),
                   (1, 31, 29, 320), (2, 13, 7, 37)]


@pytest.mark.parametrize('shape', GN1_BF16_SHAPES)
def test_gn1_stats_bf16(dev, shape):
    gen = torch.Generator(dev).manual_seed(4)
    x = rnd(gen, *shape, off=0.3).to(BF)
    check_bf16(launched('gn1_stats', lambda: stats.gn1_stats(x)),
               stats.gn1_stats_plain(x), 2)


@pytest.mark.parametrize('shape', GN1_BF16_SHAPES)
@pytest.mark.parametrize('offset', [0, 1])
def test_gn1_stats_bf16_repeat_bit_for_bit(dev, shape, offset):
    """K4 in bf16 adds per slab of pixels and then over the slabs in a fixed
    order, no atomics: a second call gives the same bits; from a pointer one
    element past 16-byte alignment (offset 1) it takes the scalar loads, in
    the same order, so the same bits again."""
    gen = torch.Generator(dev).manual_seed(21)
    n = torch.Size(shape).numel()
    base = (rnd(gen, n + 1, off=0.3) * 2.0).to(BF)
    x = base[offset:offset + n].view(shape)
    one, two = stats.gn1_stats(x), stats.gn1_stats(x)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    check_bf16(one, stats.gn1_stats_plain(x), 2)
    if offset:   # the same values from an aligned copy
        for a, b in zip(one, stats.gn1_stats(x.clone())):
            assert torch.equal(a, b)


@pytest.mark.parametrize('B,H,W,cin,cout', PREACT_SHAPES)
def test_conv3x3_preact_bf16(dev, B, H, W, cin, cout):
    gen = torch.Generator(dev).manual_seed(8)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    a, t = rnd(gen, B, cin, off=1.0), rnd(gen, B, cin, scale=2.0)
    x, w, b, a, t = bf16(x, w, b, a, t)
    check_bf16(launched('conv3x3_preact', lambda: conv.conv3x3_preact(
        x, w, b, a, t)), conv.conv3x3_preact_plain(x, w, b, a, t), 0)


# ---- the tensor-core core's edges: the ragged last pixel tile, cin = 6 (K =
# 54 in one slice), cin = 96 (a 64-channel chunk half used), cout = 3 (the
# 8-column tile, weights stored by the producers), 24 and 96 (TMA boxes past
# cout), 64 and 512 (the 64- and 128-column tiles), stride 2 at an odd width
TC_CONV3X3 = [
    (1, 11, 13, 64, 64, 1), (2, 9, 15, 6, 64, 1), (1, 10, 13, 64, 3, 1),
    (1, 12, 11, 64, 24, 1), (1, 7, 19, 96, 96, 1), (1, 6, 22, 256, 512, 1),
    (2, 13, 17, 64, 64, 2), (1, 15, 21, 96, 24, 2)]


@pytest.mark.parametrize('B,H,W,cin,cout,stride', TC_CONV3X3)
@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('act', [None, 'swish'])
@pytest.mark.parametrize('emit_stats', [False, True])
def test_conv3x3_bf16_tensor_core_edges(dev, B, H, W, cin, cout, stride,
                                        fold, act, emit_stats):
    gen = torch.Generator(dev).manual_seed(20)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    a, t = rnd(gen, B, cin, off=1.0), rnd(gen, B, cin, scale=0.2)
    x, w, b, a, t = bf16(x, w, b, a, t)
    kw = dict(stride=stride, act=act, emit_stats=emit_stats)
    if fold:
        kw.update(norm_scale=a, norm_shift=t)
    got = launched('conv3x3', lambda: conv.conv3x3(x, w, b, **kw))
    check_bf16(got, conv.conv3x3_plain(x, w, b, **kw), 2 * emit_stats)


@pytest.mark.parametrize('cout', [24, 64])
@pytest.mark.parametrize('emit_stats', [False, True])
def test_upconv2x_bf16_tensor_core(dev, cout, emit_stats):
    """The packed upsampling: K2 on (9 * cin, 4 * cout) phase-packed
    weights, a ragged last pixel tile."""
    gen = torch.Generator(dev).manual_seed(21)
    cin = 64
    x = rnd(gen, 1, 9, 17, cin, scale=0.5).to(BF)
    k = rnd(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(BF)
    b = rnd(gen, cout, scale=0.1).to(BF)
    wp = conv.pack_up_kernel(k).reshape(9 * cin, 4 * cout).contiguous()
    bp = b.repeat(4)
    got = launched('conv3x3', lambda: conv.upconv2x(x, wp, bp,
                                                    emit_stats=emit_stats))
    want = conv.conv3x3_plain(x, wp, bp, emit_stats=emit_stats)
    if emit_stats:
        y, (s, q) = want
        want = (conv.depth_to_space2(y), (s.reshape(1, 4, cout).sum(1),
                                          q.reshape(1, 4, cout).sum(1)))
    else:
        want = conv.depth_to_space2(want)
    check_bf16(got, want, 2 * emit_stats)


TC_PREACT = [(1, 11, 13, 64, 3), (2, 9, 15, 6, 24), (1, 10, 13, 64, 64),
             (1, 7, 19, 96, 96), (1, 6, 22, 128, 512)]


@pytest.mark.parametrize('B,H,W,cin,cout', TC_PREACT)
def test_conv3x3_preact_bf16_tensor_core_edges(dev, B, H, W, cin, cout):
    gen = torch.Generator(dev).manual_seed(22)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    a, t = rnd(gen, B, cin, off=1.0), rnd(gen, B, cin, scale=2.0)
    x, w, b, a, t = bf16(x, w, b, a, t)
    check_bf16(launched('conv3x3_preact', lambda: conv.conv3x3_preact(
        x, w, b, a, t)), conv.conv3x3_preact_plain(x, w, b, a, t), 0)


# K3: TMA for both operands where cin % 8 == 0 (a ragged last tile of the
# B * H * W rows), the producers' scalar path at cin = 6 and 70, the 8-column
# tile at cout = 3
TC_CONV1X1 = [(1, 11, 13, 64, 64), (2, 9, 15, 6, 64), (1, 10, 13, 64, 3),
              (1, 12, 11, 64, 24), (2, 7, 19, 96, 96), (1, 6, 22, 1024, 512),
              (1, 5, 7, 70, 128)]


@pytest.mark.parametrize('B,H,W,cin,cout', TC_CONV1X1)
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv1x1_bf16_tensor_core_edges(dev, B, H, W, cin, cout, act):
    gen = torch.Generator(dev).manual_seed(23)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w, b = rnd(gen, cin, cout, scale=cin ** -0.5), rnd(gen, cout, scale=0.1)
    x, w, b = bf16(x, w, b)
    check_bf16(launched('conv1x1', lambda: conv.conv1x1(x, w, b, act=act)),
               conv.conv1x1_plain(x, w, b, act=act), 0)


@pytest.mark.parametrize('B,H,W,cin,cout,stride', [
    (1, 40, 37, 64, 64, 1), (2, 33, 65, 192, 128, 1), (1, 29, 31, 6, 64, 1),
    (1, 41, 43, 64, 3, 2)])
def test_conv3x3_bf16_statistics_repeat_bit_for_bit(dev, B, H, W, cin, cout,
                                                     stride):
    """K2's bf16 statistics are added per pixel tile and then over the tiles
    in a fixed order, no atomics: a second call gives the same bits; so does
    K3's output."""
    gen = torch.Generator(dev).manual_seed(24)
    x = rnd(gen, B, H, W, cin, scale=0.5)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    a, t = rnd(gen, B, cin, off=1.0), rnd(gen, B, cin, scale=0.2)
    x, w, b, a, t = bf16(x, w, b, a, t)
    kw = dict(stride=stride, act='swish', emit_stats=True, norm_scale=a,
              norm_shift=t)
    first, second = (flat(conv.conv3x3(x, w, b, **kw)) for _ in range(2))
    for f, s in zip(first, second):
        assert torch.equal(f, s)
    w1 = rnd(gen, cin, cout, scale=cin ** -0.5).to(BF)
    assert torch.equal(conv.conv1x1(x, w1, b), conv.conv1x1(x, w1, b))


# ---- the bf16 forms of K5 and K6 (training under --compute_dtype bf16), on
# the tensor cores: their C -> C cases at C = 32, 64, 192 and 512, then the
# edges: ragged 8 x 16 pixel tiles (18 x 18), odd sizes, K6 at cin 3 and 6
# (the scalar staging), cout 3 (the 8-column tile and a D of 3 columns),
# the packed upsampling (cout 512), a half-used 64-channel chunk (96)
BWD_BF16_C = [32, 64, 192, 512]


def bwd_shape(C):
    return (2, 13, 21) if C <= 64 else (1, 9, 11)


K5_BF16_SHAPES = [bwd_shape(C) + (C,) for C in BWD_BF16_C] + [
    (2, 18, 18, 32), (2, 18, 18, 512), (1, 7, 9, 192), (3, 17, 19, 64)]
K6_BF16_SHAPES = [bwd_shape(C) + (C, C) for C in BWD_BF16_C] + [
    (2, 18, 18, 6, 64), (2, 18, 18, 3, 64), (2, 18, 18, 64, 3),
    (1, 18, 18, 128, 512), (2, 18, 18, 512, 512), (3, 7, 9, 96, 24),
    (1, 37, 29, 192, 64)]


@pytest.mark.parametrize('B,H,W,C', K5_BF16_SHAPES)
@pytest.mark.parametrize('fold_attw', [False, True])
def test_akgm_tail_backward_bf16(dev, B, H, W, C, fold_attw):
    """K5 in bf16 against its bf16 plain version, every output; dW, dbias
    and dattw the same bits in a second call."""
    gen, G = torch.Generator(dev).manual_seed(18), 8
    h, att, w, b = bf16(*akgm_operands(gen, B, H, W, C))
    go = rnd(gen, B, H, W, C).to(BF)
    ns = nt = aw = None
    if fold_attw:
        ns, nt, aw = bf16(rnd(gen, B, C, scale=0.2, off=1.0),
                          rnd(gen, B, C, scale=0.2),
                          rnd(gen, B, G, scale=0.3, off=1.0))

    def run():
        return akgm.akgm_block_tail_backward_kernel(h, att, w, b, go, G, ns,
                                                    nt, aw)
    got = launched('akgm_tail_bwd', run)
    want = akgm.akgm_block_tail_backward_plain(
        h, att, w, b, go, G, norm_scale=ns, norm_shift=nt, attw=aw)
    assert (got[4] is None) == (want[4] is None) == (not fold_attw)
    n = 5 if fold_attw else 4
    # dattw: 8 values an image, see check_bf16
    check_bf16(got[:n], want[:n], 0, {4: akgm_dattw_bf16_exact(
        h, att, w, b, go, G, ns, nt, aw)} if fold_attw else None)
    again = run()
    for i in (2, 3, 4)[:n - 2]:
        assert torch.equal(got[i], again[i]), i


@pytest.mark.parametrize('B,H,W,cin,cout', K6_BF16_SHAPES)
@pytest.mark.parametrize('fold_act', [False, True])
def test_conv3x3_backward_bf16(dev, B, H, W, cin, cout, fold_act):
    """K6 in bf16 against its bf16 plain version; dW and dbias the same bits
    in a second call."""
    gen = torch.Generator(dev).manual_seed(19)
    x, go = rnd(gen, B, H, W, cin, scale=0.5), rnd(gen, B, H, W, cout)
    w = rnd(gen, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    b = rnd(gen, cout, scale=0.1)
    a = t = None
    if fold_act:
        a, t = (rnd(gen, B, cin, scale=0.2, off=1.0),
                rnd(gen, B, cin, scale=0.2))
    x, go, w, b, a, t = bf16(x, go, w, b, a, t)
    act = 'swish' if fold_act else None

    def run():
        return conv.conv3x3_backward_kernel(x, w, b, go, act, a, t)
    got = launched('conv3x3_bwd', run)
    check_bf16(got, conv.conv3x3_backward_plain(
        x, w, b, go, act=act, norm_scale=a, norm_shift=t), 0)
    again = run()
    for i in (1, 2):
        assert torch.equal(got[i], again[i]), i


def test_kernels_without_a_bf16_form_refuse_bf16(dev):
    """K8 and K9 take float32: a bf16 operand raises, it is never cast."""
    gen, G, C = torch.Generator(dev).manual_seed(16), 8, 16
    h, att, w, b = bf16(*akgm_operands(gen, 1, 5, 6, C))
    with pytest.raises(TypeError, match='float32'):
        akgm.akgm_mix(h, att, w, b, G)
    with pytest.raises(TypeError, match='float32'):
        akgm.akgm_block_tail_packed(h, att, akgm.pack_grouped_weight(w, G),
                                    b, h, G)
