"""The port's three further kernels' functions (on the CPU through their plain
versions) and the model variants that reach them, against the JAX package:
the pre-activated 3x3 conv (the folded head), the AKGM mix alone, and the
group-packed AKGM tail; `DY3h(dropout=0)` and `DY3h(tail=...)`.

The same numpy inputs go through both sides; the Pallas kernels run in
interpret mode. Tolerances, float32 on both sides: 1e-5 abs / 1e-4 rel for
one op (the two sides sum the same products in other orders), 1e-4 abs for a
whole network, 1e-4 rel (of the gradient's largest entry) for gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucdir_tpu.models.dy3h import DY3h as JaxDY3h
from ucdir_tpu.models.dy3h import compute_guide_maps as jax_guide_maps
from ucdir_tpu.models.layers import pad_to_multiple as jax_pad
from ucdir_tpu.ops.akgm import akgm_mix_reference as jax_mix_reference
from ucdir_tpu.ops.akgm_pallas import (_akgm_block_forward_packed,
                                       _block_ref, _expand_matrix,
                                       _pack_grouped_kernel, akgm_mix_pallas)
from ucdir_tpu.ops.conv_pallas import _c3p_ref, conv3x3_preact_pallas
from ucdir_tpu_torch.configs import SID_MODEL
from ucdir_tpu_torch.models import factory
from ucdir_tpu_torch.models.akgm import ResnetBlockDY3h
from ucdir_tpu_torch.models.dy3h import DY3h, compute_guide_maps
from ucdir_tpu_torch.models.layers import pad_to_multiple
from ucdir_tpu_torch.ops import _build
from ucdir_tpu_torch.ops.akgm import (akgm_block_tail,
                                      akgm_block_tail_packed,
                                      akgm_block_tail_packed_plain, akgm_mix,
                                      pack_grouped_weight)
from ucdir_tpu_torch.ops.conv import conv3x3_preact, conv3x3_preact_plain
from ucdir_tpu_torch.utils import convert_jax

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
G = 8


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def normal(rng, *shape, scale=0.5, off=0.0):
    return (rng.standard_normal(shape) * scale + off).astype(np.float32)


def T(a):
    return None if a is None else torch.from_numpy(a)


def J(a):
    return None if a is None else jnp.asarray(a)


def conv_data(rng, B=2, H=8, W=16, cin=16, cout=3):
    # large shifts push many values far below 0, where swish is near 0
    return (normal(rng, B, H, W, cin), normal(rng, 3, 3, cin, cout, scale=0.1),
            normal(rng, cout, scale=0.1), normal(rng, B, cin, scale=0.3, off=1.),
            normal(rng, B, cin, scale=2.0))


def tail_data(rng, B=2, H=8, W=16, C=16, fold=True, attw=True):
    # C / G = 2: a wrong pairing of candidates and groups changes the output
    d = dict(h=normal(rng, B, H, W, C), att=normal(rng, B, H, W, G),
             k=normal(rng, 3, 3, C // G, C * G, scale=0.2),
             b=normal(rng, C * G, scale=0.2), res=normal(rng, B, H, W, C),
             a=None, t=None, aw=None)
    if fold:
        d.update(a=normal(rng, B, C, scale=0.3, off=1.),
                 t=normal(rng, B, C, scale=0.2))
    if attw:
        d['aw'] = normal(rng, B, G, scale=0.5, off=1.)
    return d


@pytest.mark.parametrize('cout', [3, 24])
def test_conv3x3_preact_matches_pallas_and_reference(rng, cout):
    x, k, b, a, t = conv_data(rng, cout=cout)
    with pltpu.force_tpu_interpret_mode():
        want = conv3x3_preact_pallas(J(x), J(k), J(b), J(a), J(t))
    ref = _c3p_ref(J(x), J(k), J(b), J(a), J(t))
    w = T(k).reshape(9 * x.shape[-1], cout)
    got = conv3x3_preact(T(x), w, T(b), T(a), T(t))
    close(got, want)
    close(got, ref)
    close(conv3x3_preact_plain(T(x), w, T(b), T(a), T(t)), ref)


def test_conv3x3_preact_border_is_the_activated_zero(rng):
    """With a huge negative shift the activated tensor is 0 everywhere, the
    padding included: the output is the bias alone."""
    x, k, b, a, _ = conv_data(rng, B=1)
    t = np.full_like(a, -200.)
    got = conv3x3_preact(T(x), T(k).reshape(-1, 3), T(b), T(a), T(t))
    assert torch.isfinite(got).all()
    close(got, np.broadcast_to(b, got.shape), atol=1e-6)


@pytest.mark.parametrize('B,H,W,C', [(1, 6, 16, 16), (2, 8, 24, 32)])
def test_akgm_mix_matches_pallas(rng, B, H, W, C):
    d = tail_data(rng, B, H, W, C, fold=False, attw=False)
    with pltpu.force_tpu_interpret_mode():
        want = akgm_mix_pallas(J(d['h']), J(d['att']), J(d['k']), J(d['b']), G)
    got = akgm_mix(T(d['h']), T(d['att']), T(d['k']).reshape(-1, C * G),
                   T(d['b']), G)
    close(got, want)
    close(got, jax_mix_reference(J(d['h']), J(d['att']), J(d['k']),
                                 J(d['b']), G))


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('attw', [False, True])
def test_packed_tail_matches_pallas(rng, fold, attw):
    d = tail_data(rng, fold=fold, attw=attw)
    C = d['h'].shape[-1]
    with pltpu.force_tpu_interpret_mode():
        want = _akgm_block_forward_packed(
            J(d['h']), J(d['att']), J(d['k']), J(d['b']), J(d['res']), G,
            J(d['a']), J(d['t']), J(d['aw']))
    wp = pack_grouped_weight(T(d['k']).reshape(-1, C * G), G)
    kw = dict(norm_scale=T(d['a']), norm_shift=T(d['t']), attw=T(d['aw']))
    close(akgm_block_tail_packed(T(d['h']), T(d['att']), wp, T(d['b']),
                                 T(d['res']), G, **kw), want)
    close(akgm_block_tail_packed_plain(T(d['h']), T(d['att']), wp, T(d['b']),
                                       T(d['res']), G, **kw), want)


@pytest.mark.parametrize('C', [16, 64])
def test_pack_grouped_weight_matches_jax(rng, C):
    k = normal(rng, 3, 3, C // G, C * G)
    want = np.asarray(_pack_grouped_kernel(J(k), C, G))
    got = pack_grouped_weight(T(k).reshape(9 * C // G, C * G), G)
    assert got.shape == (9 * C, C)
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_and_fused_tails_differ(rng):
    """The packed form pairs candidates with other input groups: on random
    weights its output is far from the fused tail's (which equals the JAX
    reference), so a wrong pairing cannot pass for the right one."""
    d = tail_data(rng)
    C = d['h'].shape[-1]
    w = T(d['k']).reshape(-1, C * G)
    args = (T(d['h']), T(d['att']))
    kw = dict(norm_scale=T(d['a']), norm_shift=T(d['t']), attw=T(d['aw']))
    fused = akgm_block_tail(*args, w, T(d['b']), T(d['res']), G, **kw)
    packed = akgm_block_tail_packed(*args, pack_grouped_weight(w, G),
                                    T(d['b']), T(d['res']), G, **kw)
    close(fused, _block_ref(J(d['h']), J(d['att']), J(d['k']), J(d['b']),
                            J(d['res']), G, J(d['a']), J(d['t']), J(d['aw'])))
    assert (fused - packed).abs().max().item() > 0.1


def _rel_close(got, want, what):
    # 1e-4 of the gradient's largest entry (sums in other orders)
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 1e-4 * scale, (what, err, scale)


def test_conv3x3_preact_gradients_match_jax(rng):
    x, k, b, a, t = conv_data(rng, B=1, H=6, W=8, cin=8)
    go = normal(rng, 1, 6, 8, 3)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(conv3x3_preact_pallas, J(x), J(k), J(b), J(a), J(t))
        want = vjp(J(go))
    leaves = [T(v).requires_grad_() for v in (x, k, b, a, t)]
    out = conv3x3_preact(leaves[0], leaves[1].reshape(-1, 3), *leaves[2:])
    got = torch.autograd.grad(out, leaves, T(go))
    for name, g, w in zip('x k b a t'.split(), got, want):
        _rel_close(g, w, name)


def test_akgm_mix_gradients_match_jax(rng):
    d = tail_data(rng, B=1, H=4, W=8, fold=False, attw=False)
    go = normal(rng, 1, 4, 8, 16)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: akgm_mix_pallas(*a, G), J(d['h']),
                         J(d['att']), J(d['k']), J(d['b']))
        want = vjp(J(go))
    leaves = [T(d[n]).requires_grad_() for n in ('h', 'att', 'k', 'b')]
    out = akgm_mix(leaves[0], leaves[1], leaves[2].reshape(-1, 16 * G),
                   leaves[3], G)
    got = torch.autograd.grad(out, leaves, T(go))
    for name, g, w in zip('h att k b'.split(), got, want):
        _rel_close(g, w, name)


def _jax_packed_formula(h, att, k, b, res, a, t, aw):
    """The packed kernel's identity in plain jnp, from the JAX package's own
    packing: (im2col(h * a + t) * att_expanded) @ W_packed + att @ B, then
    swish and the residual. Differentiable, unlike the Pallas forward."""
    B, H, W, C = h.shape
    hh = jnp.pad(h * a[:, None, None, :] + t[:, None, None, :],
                 ((0, 0), (1, 1), (1, 1), (0, 0)))
    A = att * aw[:, None, None, :]
    cols = jnp.concatenate([hh[:, y:y + H, x:x + W, :]
                            for y in range(3) for x in range(3)], axis=-1)
    att_exp = jnp.tile(A @ jnp.asarray(_expand_matrix(C, G, np.float32)),
                       (1, 1, 1, 9))
    y = (cols * att_exp) @ _pack_grouped_kernel(k, C, G) \
        + A @ b.reshape(C, G).T
    return y * jax.nn.sigmoid(y) + res


def test_packed_tail_gradients_match_jax(rng):
    d = tail_data(rng, B=1, H=4, W=8)
    names = ('h', 'att', 'k', 'b', 'res', 'a', 't', 'aw')
    go = normal(rng, 1, 4, 8, 16)
    jargs = [J(d[n]) for n in names]
    with pltpu.force_tpu_interpret_mode():
        kernel_out = _akgm_block_forward_packed(
            *jargs[:5], G, jargs[5], jargs[6], jargs[7])
    out_j, vjp = jax.vjp(_jax_packed_formula, *jargs)
    close(out_j, kernel_out)     # the formula is the kernel's function
    want = vjp(J(go))
    leaves = {n: T(d[n]).requires_grad_() for n in names}
    wp = pack_grouped_weight(leaves['k'].reshape(-1, 16 * G), G)
    out = akgm_block_tail_packed(
        leaves['h'], leaves['att'], wp, leaves['b'], leaves['res'], G,
        norm_scale=leaves['a'], norm_shift=leaves['t'], attw=leaves['aw'])
    close(out.detach(), out_j)
    got = torch.autograd.grad(out, list(leaves.values()), T(go))
    for name, g, w in zip(names, got, want):
        _rel_close(g, w, name)


DY3H_CFG = dict(in_channel=6, out_channel=3, inner_channel=16,
                channel_mults=(1, 2), attn_res=(32,), res_blocks=1,
                dropout=0.0, norm_groups=1, image_size=64)


def _state(fn, params):
    out = {}
    fn(jax.tree_util.tree_map(np.asarray, params), '', out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope='module')
def dy3h_pair():
    jm = JaxDY3h(**DY3H_CFG)
    x = np.zeros((1, 64, 64, 6), np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), x,
                              np.ones((1, 1), np.float32),
                              x[..., :3])['params']
    pm = DY3h(**DY3H_CFG).eval()
    pm.load_state_dict(_state(convert_jax._dy3h, params), strict=True)
    return jm, params, pm


@pytest.mark.parametrize('hoisted', [False, True])
def test_dy3h_folded_head_matches_jax(rng, dy3h_pair, hoisted, monkeypatch):
    """dropout == 0: both packages fold GroupNorm -> swish -> conv into one
    pre-activated conv fed by the chained statistics. 1e-4 abs over the whole
    network."""
    jm, params, pm = dy3h_pair
    x, guide = normal(rng, 1, 80, 80, 6), normal(rng, 1, 80, 80, 3)
    nl = np.full((1, 1), 0.7, np.float32)
    gm = pgm = None
    if hoisted:
        gm = jax_guide_maps(jm, params, jax_pad(jnp.asarray(guide), 32)[0])
        pgm = compute_guide_maps(pm, pad_to_multiple(T(guide), 32)[0])
    want = jax.jit(lambda p, g: jm.apply({'params': p}, x, nl, guide,
                                         guide_maps=g))(params, gm)
    calls = []
    import ucdir_tpu_torch.models.dy3h as port_dy3h
    monkeypatch.setattr(port_dy3h, 'conv3x3_preact',
                        lambda *a: calls.append(1) or conv3x3_preact(*a))
    with torch.no_grad():
        got = pm(T(x), T(nl), T(guide), guide_maps=pgm)
    assert calls == [1]          # the head went through the folded conv
    assert got.shape == (1, 80, 80, 3)
    close(got, want, atol=1e-4)


def test_dy3h_head_with_dropout_stays_unfolded(rng, monkeypatch):
    import ucdir_tpu_torch.models.dy3h as port_dy3h
    monkeypatch.setattr(port_dy3h, 'conv3x3_preact', None)  # must not be hit
    pm = DY3h(**dict(DY3H_CFG, dropout=0.1)).eval()
    with torch.no_grad():
        out = pm(T(normal(rng, 1, 32, 32, 6)), torch.full((1, 1), 0.5),
                 T(normal(rng, 1, 32, 32, 3)))
    assert out.shape == (1, 32, 32, 3)


@pytest.mark.parametrize('tail', ['mix', 'packed'])
def test_dy3h_tails(rng, dy3h_pair, tail):
    """tail='mix' is the fused tail's function in other pieces (1e-5 abs);
    tail='packed' is another network (far from it). The state dict's names do
    not depend on the tail."""
    _, _, fused = dy3h_pair
    other = DY3h(**DY3H_CFG, tail=tail).eval()
    assert list(other.state_dict()) == list(fused.state_dict())
    other.load_state_dict(fused.state_dict(), strict=True)
    x, guide = T(normal(rng, 2, 64, 64, 6)), T(normal(rng, 2, 64, 64, 3))
    nl = torch.tensor([[0.7], [0.3]])
    with torch.no_grad():
        want, got = fused(x, nl, guide), other(x, nl, guide)
    diff = (got - want).abs().max().item()
    if tail == 'mix':
        assert diff <= 1e-5, diff
    else:
        assert diff > 1e-3, diff


def test_block_rejects_an_unknown_tail():
    with pytest.raises(ValueError, match='tail'):
        ResnetBlockDY3h(16, 16, 16, tail='dense')


@pytest.mark.parametrize('env,want', [
    ({}, 'fused'), ({'UCDIR_TPU_NO_FUSED_TAIL': '1'}, 'mix'),
    ({'UCDIR_TPU_AKGM_PACKED': '1'}, 'packed'),
    ({'UCDIR_TPU_NO_FUSED_TAIL': '1', 'UCDIR_TPU_AKGM_PACKED': '1'}, 'mix')])
def test_factory_reads_the_tail_switches(monkeypatch, env, want):
    """The JAX package's two switches choose the port's tail too, read once
    when the model is built; a config's own `unet.tail` wins."""
    for name in ('UCDIR_TPU_NO_FUSED_TAIL', 'UCDIR_TPU_AKGM_PACKED'):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    model = dict(SID_MODEL, unet=dict(SID_MODEL['unet'], inner_channel=8,
                                      channel_mults=[1, 2], res_blocks=1,
                                      attn_res=[]))
    net = factory.define_G({'model': model}).denoise_fn
    assert {m.tail for m in net.modules()
            if isinstance(m, ResnetBlockDY3h)} == {want}
    model['unet']['tail'] = 'fused'
    net = factory.define_G({'model': model}).denoise_fn
    assert {m.tail for m in net.modules()
            if isinstance(m, ResnetBlockDY3h)} == {'fused'}


def test_every_kernel_has_a_launch_count():
    # every entry point, the bf16 forms of K1, K2, K3, K4 and K7 among them
    kernels = {'akgm_tail', 'conv3x3', 'conv1x1', 'gn1_stats',
               'akgm_tail_bwd', 'conv3x3_bwd', 'conv3x3_preact', 'akgm_mix',
               'akgm_packed'}
    assert set(_build.LAUNCHES) == set(_build._SIGNATURES) == kernels | {
        'akgm_tail_bf16', 'conv3x3_bf16', 'conv1x1_bf16', 'gn1_stats_bf16',
        'conv3x3_preact_bf16'}
