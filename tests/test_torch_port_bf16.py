"""The port's bfloat16 validation path (`--compute_dtype bf16`) against the
JAX package's, on the CPU.

Ops: the bf16 plain version of each kernel on the validation path (K1, K2
plain, folded with swish and statistics, stride 2 and on packed upsampling
weights, K3, K4 and K7), which the CPU runs in place of the kernel, against
the JAX Pallas function in interpret mode on the same numpy draws rounded to
bfloat16. Both compute in float32 on the same bf16 operands and round at the
same places (the staged x * a and + t, K1's att * attw, z and z * att, the
packed upsampling weights' two products, the output); their float32 sums run
in other orders, and a sum next to a rounding boundary can flip an
intermediate or the output by one ulp. Tolerance: outputs within 2 bf16 ulps
of the largest |value|, 2^-6 * max|want|, and at least 99% of them the same
bits (readings: 100%, and 99.98% for the folded conv). K7 is held to the
ulps alone: XLA's interpret mode keeps its staged swish's sigmoid argument
x * a + t unrounded (excess precision), where the kernel's source rounds it
to bf16 as the port does; 40% of K7's outputs differ by one ulp, and with
the argument unrounded they are the same bits. Statistics: each side's are
the float32 sums of its own rounded output (1e-5 of the largest sum of
squares), and the two sides' differ by no more than their n outputs a
channel can: n times the outputs' tolerance (sums of squares: times 2 *
max|want| + tolerance).

Slice: a tiny model through `super_resolution(compute_dtype=bf16)`, the port
against the JAX package's with the same weights (convert_torch) and the JAX
sampler's draws, 3 DDPM steps. The JAX package's CPU path is its XLA
composition, which rounds where that composition does (the convolution's
output, then + bias, then the swish, each in bf16), not where the Pallas
kernels round, so the two bf16 runs agree to the size of a bf16 rounding
schedule itself, the distance of either from float32: sr within 2.5e-3 mean
abs and 3e-2 max abs (readings 9.6e-4 and 1.02e-2; bf16 against float32
reads 1.0e-3 and 9.4e-3); initx, the predictor alone, within 2^-8 abs, one
bf16 ulp of values below 1 (reading 2^-10). The port's bf16 stays within
the JAX test's 0.05 mean abs of its own float32 (tests/test_diffusion.py
`test_bf16_sampling_close_to_fp32`), and the result is float32.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucdir_tpu.diffusion.sampler import super_resolution as jax_sr
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.ops.akgm_pallas import _akgm_block_forward
from ucdir_tpu.ops.conv_pallas import (_conv1x1_forward, _conv3x3_forward,
                                       _downconv_forward, _pack_up_kernel,
                                       conv3x3_preact_pallas,
                                       depth_to_space2)
from ucdir_tpu.ops.stats_pallas import gn1_stats_pallas
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
from ucdir_tpu_torch.diffusion.sampler import super_resolution
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.ops import _build
from ucdir_tpu_torch.ops.akgm import akgm_block_tail
from ucdir_tpu_torch.ops.conv import (conv1x1, conv3x3, conv3x3_preact,
                                      pack_up_kernel, upconv2x)
from ucdir_tpu_torch.ops.stats import gn1_stats
from ucdir_tpu_torch.schedule import make_schedule

from test_torch_port_slice import _write_pairs, jax_draws

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16


def draws(rng, *shapes, scale=0.5, off=0.0):
    """float32 numpy draws already rounded to bfloat16."""
    return [torch.from_numpy((rng.standard_normal(s) * scale + off)
                             .astype(np.float32)).to(BF).float().numpy()
            for s in shapes]


def T(a):
    return None if a is None else torch.from_numpy(a).to(BF)


def J(a):
    return None if a is None else jnp.asarray(a, jnp.bfloat16)


def f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def out_tol(want):
    return 2. ** -6 * np.abs(want).max()


def check_out(got, want, same=0.99):
    assert got.dtype == BF
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= out_tol(want), (err, out_tol(want))
    assert (got == want).mean() >= same


def check_stats(out, s, q, want, ws, wq):
    """Each side's statistics are the float32 sums of its own output; the
    two sides' differ by no more than their n outputs a channel can."""
    out, want = f32(out), f32(want)
    s, q = s.numpy(), q.numpy()
    ws, wq = f32(ws).reshape(s.shape), f32(wq).reshape(q.shape)
    for o, ss, qq in ((out, s, q), (want, ws, wq)):
        scale = 1e-5 * max(1., np.abs(qq).max())
        np.testing.assert_allclose(ss, o.sum(axis=(1, 2)), atol=scale, rtol=0)
        np.testing.assert_allclose(qq, (o * o).sum(axis=(1, 2)), atol=scale,
                                   rtol=0)
    n, tol = want.shape[1] * want.shape[2], out_tol(want)
    np.testing.assert_allclose(s, ws, atol=n * tol, rtol=0)
    np.testing.assert_allclose(
        q, wq, atol=n * tol * (2 * np.abs(want).max() + tol), rtol=0)


def fold_draws(rng, B, C, fold):
    if not fold:
        return None, None
    return (*draws(rng, (B, C), scale=0.3, off=1.0),
            *draws(rng, (B, C), scale=0.2))


@pytest.mark.parametrize('fold', [False, True])
def test_akgm_block_tail_bf16_matches_pallas(rng, fold):
    # C / G = 2, so a candidate-pairing fault changes the output
    B, H, W, C, G = 2, 8, 16, 16, 8
    h, att, res = draws(rng, (B, H, W, C), (B, H, W, G), (B, H, W, C))
    k, b = draws(rng, (3, 3, C // G, C * G), (C * G,), scale=0.3)
    (aw,) = draws(rng, (B, G), off=1.0)
    a, t = fold_draws(rng, B, C, fold)
    with pltpu.force_tpu_interpret_mode():
        want, ws, wq = _akgm_block_forward(
            J(h), J(att), J(k), J(b), J(res), G, J(a), J(t), J(aw),
            emit_stats=True)
    got, (s, q) = akgm_block_tail(
        T(h), T(att), T(k).reshape(9 * C // G, C * G), T(b), T(res), G,
        norm_scale=T(a), norm_shift=T(t), attw=T(aw), emit_stats=True)
    check_out(got, want)
    check_stats(got, s, q, want, ws, wq)


# The edges of the bf16 kernels' tiles (csrc/igemm_tc.cuh), whose plain
# versions the card holds the kernels against: a ragged last pixel tile of
# 128 (9 x 15 = 135 pixels), cin = 6 (K = 54), cout = 3, stride 2 at odd
# sizes.
@pytest.mark.parametrize('B,H,W,cin,cout', [
    (2, 8, 16, 16, 24), (1, 9, 15, 8, 16), (1, 7, 11, 6, 16),
    (1, 9, 13, 16, 3)])
@pytest.mark.parametrize('fold_act', [False, True])
def test_conv3x3_bf16_matches_pallas(rng, fold_act, B, H, W, cin, cout):
    (x,) = draws(rng, (B, H, W, cin))
    k, b = draws(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    a, t = fold_draws(rng, B, cin, fold_act)
    act = 'swish' if fold_act else None
    with pltpu.force_tpu_interpret_mode():
        want, ws, wq = _conv3x3_forward(J(x), J(k), J(b), act, J(a), J(t),
                                        emit_stats=True)
    got, (s, q) = conv3x3(T(x), T(k).reshape(9 * cin, cout), T(b), act=act,
                          norm_scale=T(a), norm_shift=T(t), emit_stats=True)
    check_out(got, want)
    check_stats(got, s, q, want, ws, wq)


@pytest.mark.parametrize('B,H,W,cin,cout', [
    (1, 16, 16, 8, 16), (1, 9, 13, 8, 16), (1, 10, 13, 6, 3)])
def test_conv3x3_stride2_bf16_matches_pallas_downconv(rng, B, H, W, cin,
                                                      cout):
    """At an odd size the port's stride-2 conv has (H + 1) // 2 rows, the
    Pallas kernel H // 2 (the JAX model only downsamples even sizes): the
    Pallas output is the port's first rows and columns. The port's
    statistics are those of its whole output; those of the rows and columns
    both sides compute are held against Pallas's."""
    (x,) = draws(rng, (B, H, W, cin))
    k, b = draws(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want, ws, wq = _downconv_forward(J(x), J(k), J(b), emit_stats=True)
    got, (s, q) = conv3x3(T(x), T(k).reshape(9 * cin, cout), T(b), stride=2,
                          emit_stats=True)
    assert got.shape == (B, (H + 1) // 2, (W + 1) // 2, cout)
    check_out(got[:, :H // 2, :W // 2], want)
    if H % 2 == W % 2 == 0:
        check_stats(got, s, q, want, ws, wq)
    else:
        check_stats(got, s, q, got, s, q)
        crop = got[:, :H // 2, :W // 2].float()
        check_stats(crop, crop.sum((1, 2)), (crop * crop).sum((1, 2)), want,
                    ws, wq)


@pytest.mark.parametrize('B,H,W,cin,cout', [(1, 8, 10, 8, 12),
                                             (1, 9, 15, 6, 3)])
def test_upconv2x_bf16_matches_pallas(rng, B, H, W, cin, cout):
    """B5 on the TPU: the packed weights in bf16 (the taps of a source pixel
    added, then rounded), then B2 on them, then depth-to-space."""
    (x,) = draws(rng, (B, H, W, cin))
    k, b = draws(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    kp = _pack_up_kernel(J(k)).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        y, ws, wq = _conv3x3_forward(J(x), kp, jnp.tile(J(b), (4,)),
                                     emit_stats=True)
    want = depth_to_space2(y)
    wp = pack_up_kernel(T(k))
    assert wp.dtype == BF
    got, (s, q) = upconv2x(T(x), wp.reshape(9 * cin, 4 * cout),
                           T(b).repeat(4), emit_stats=True)
    assert got.shape == (B, 2 * H, 2 * W, cout)
    check_out(got, want)
    # the packed output's statistics summed over the 4 phases
    check_stats(got, s, q, want, f32(ws).reshape(B, 4, cout).sum(1),
                f32(wq).reshape(B, 4, cout).sum(1))


@pytest.mark.parametrize('B,H,W,cin,cout', [
    (2, 8, 16, 24, 16), (1, 9, 15, 6, 3), (1, 11, 13, 8, 24)])
@pytest.mark.parametrize('act', [None, 'swish'])
def test_conv1x1_bf16_matches_pallas(rng, act, B, H, W, cin, cout):
    (x,) = draws(rng, (B, H, W, cin))
    k, b = draws(rng, (1, 1, cin, cout), (cout,), scale=0.2)
    with pltpu.force_tpu_interpret_mode():
        want = _conv1x1_forward(J(x), J(k), J(b), act)
    check_out(conv1x1(T(x), T(k).reshape(cin, cout), T(b), act=act), want)


@pytest.mark.parametrize('B,H,W,cin,cout', [
    (2, 8, 16, 16, 3), (1, 9, 15, 6, 24), (1, 11, 13, 16, 3)])
def test_conv3x3_preact_bf16_matches_pallas(rng, B, H, W, cin, cout):
    (x,) = draws(rng, (B, H, W, cin))
    k, b = draws(rng, (3, 3, cin, cout), (cout,), scale=0.1)
    a, t = fold_draws(rng, B, cin, True)
    with pltpu.force_tpu_interpret_mode():
        want = conv3x3_preact_pallas(J(x), J(k), J(b), J(a), J(t))
    check_out(conv3x3_preact(T(x), T(k).reshape(9 * cin, cout), T(b), T(a),
                             T(t)), want, same=0)


@pytest.mark.parametrize('shape', [(1, 8, 16, 16), (2, 12, 16, 40)])
def test_gn1_stats_bf16_matches_pallas(rng, shape):
    (x,) = draws(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        ws, wq = gn1_stats_pallas(J(x))
    s, q = gn1_stats(T(x))
    assert s.dtype == q.dtype == torch.float32
    # float32 sums of the same bf16 values, in another order
    np.testing.assert_allclose(s.numpy(), f32(ws), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), f32(wq), atol=1e-4, rtol=1e-5)


def tiny_model_opt(**unet):
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(inner_channel=16, channel_mults=[1, 2],
                         res_blocks=1, attn_res=[], **unet)
    return model


def dispatched(monkeypatch):
    """Records the dtype of the first operand each kernel wrapper routes
    (`_build.on_host`), by the wrapper's name."""
    seen = {}
    on_host = _build.on_host

    def record(x):
        seen.setdefault(sys._getframe(1).f_code.co_name, set()).add(x.dtype)
        return on_host(x)
    monkeypatch.setattr(_build, 'on_host', record)
    return seen


def test_bf16_slice_matches_jax_and_stays_near_fp32(rng, monkeypatch):
    opt = {'model': tiny_model_opt()}
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=3)
    torch.manual_seed(0)
    model = define_G(opt).eval()
    params = convert_state_dict(model.state_dict())
    jm = jax_define_G(opt)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_sr, want_initx = jax.jit(lambda v, xx, k: jax_sr(
        jm, v, jax_make_schedule(sched_opt), xx, k,
        compute_dtype=jnp.bfloat16))({'params': params}, x, key)
    want_sr, want_initx = np.asarray(want_sr), np.asarray(want_initx)

    def run(dtype):
        d = iter(jax_draws(key, x.shape, 3))
        return super_resolution(
            model, make_schedule(sched_opt), torch.from_numpy(x),
            noise=lambda shape: torch.from_numpy(next(d)),
            compute_dtype=dtype)

    seen = dispatched(monkeypatch)
    sr, initx = run(BF)
    # every kernel of the path took bf16 operands, and none took float32
    assert {'_akgm_block_tail_forward', '_conv3x3_forward',
            '_conv1x1_forward', '_gn1_stats_forward'} <= set(seen), seen
    assert all(d == {BF} for d in seen.values()), seen
    monkeypatch.undo()
    assert sr.dtype == initx.dtype == torch.float32
    assert next(model.parameters()).dtype == torch.float32
    err = np.abs(sr.numpy() - want_sr)
    assert err.mean() <= 2.5e-3 and err.max() <= 3e-2, (err.mean(),
                                                        err.max())
    assert np.abs(initx.numpy() - want_initx).max() <= 2. ** -8
    sr32, _ = run(None)
    assert (sr - sr32).abs().mean().item() < 0.05


def test_bf16_tiled_path_runs_in_bf16(rng):
    """The tiled denoiser takes the bf16 input, guide and steps too: its
    result stays within the JAX test's 0.05 mean abs of the float32 one."""
    torch.manual_seed(1)
    model = define_G({'model': tiny_model_opt()}).eval()
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 96, 80, 3))
                         .astype(np.float32))
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=2))
    tile = {'skip': 64, 'padding': 8}
    outs = [super_resolution(model, sched, x,
                             generator=torch.Generator().manual_seed(3),
                             tile_opts=tile, compute_dtype=dt)[0]
            for dt in (BF, None)]
    assert outs[0].dtype == torch.float32
    assert torch.isfinite(outs[0]).all()
    assert (outs[0] - outs[1]).abs().mean().item() < 0.05


def test_bf16_tails_without_a_bf16_kernel_raise():
    """K8 and K9 take float32 only: a bf16 model with tail 'mix' or
    'packed' raises, it is never run in float32 instead."""
    for tail in ('mix', 'packed'):
        torch.manual_seed(0)
        model = define_G({'model': tiny_model_opt()})
        for _, layer, _ in model.denoise_fn.guide_block_scales():
            layer.res_block.tail = tail
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            super_resolution(model.eval(),
                             make_schedule(dict(SID_VAL_SCHEDULE,
                                                n_timestep=1)),
                             torch.zeros(1, 32, 32, 3),
                             generator=torch.Generator(),
                             compute_dtype=BF)


def _tiny_yaml(tmp_path, **train):
    data = str(tmp_path / 'data')
    _write_pairs(data)
    with open(os.path.join(ROOT, 'ucdir_tpu', 'configs', 'sid.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['name'] = 'sid-tiny'
    cfg['model']['unet'].update(inner_channel=8, channel_mults=[1, 2],
                                res_blocks=1, attn_res=[])
    roots = {'lq': data + '/input', 'gt': data + '/target'}
    for phase in ('train', 'val'):
        cfg['datasets'][phase]['data_args']['dataroot'] = roots
    if train:
        cfg['datasets']['train']['data_args']['crop_size'] = 32
        cfg['train'].update(train)
    (tmp_path / 'tiny.yaml').write_text(yaml.safe_dump(cfg))


def _cli(tmp_path, *args, **env):
    return subprocess.run(
        [sys.executable, '-m', 'ucdir_tpu_torch.sr', '-c', 'tiny.yaml',
         '-debug', '--device', 'cpu', '--compute_dtype', 'bf16', *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2', **env))


def test_cli_val_bf16_on_cpu(tmp_path):
    _tiny_yaml(tmp_path)
    proc = _cli(tmp_path, '-p', 'val')
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '# Validation # PSNR: ' in proc.stderr
    assert '# Validation # SSIM: ' in proc.stderr
    results = [f for _, _, fs in os.walk(tmp_path) for f in fs
               if f.endswith('_sr.jpg')]
    assert len(results) == 2


def test_cli_bf16_refusals(tmp_path):
    """bf16 training runs (`-p train --compute_dtype bf16`, 2 iterations on
    the CPU: a finite l_pix and the in-train validation at iteration 2;
    tests/test_torch_port_bf16_train.py holds its checkpoints to float32),
    and the 'mix' tail (UCDIR_TPU_NO_FUSED_TAIL=1), whose kernel K8 has no
    bf16 form, raises, naming ROADMAP.md."""
    _tiny_yaml(tmp_path, n_iter=2)
    proc = _cli(tmp_path, '-p', 'train')
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = [float(line.split('l_pix: ')[1].split()[0])
              for line in proc.stderr.splitlines() if 'l_pix: ' in line]
    assert len(losses) == 1 and np.isfinite(losses).all(), losses
    assert '# Validation # PSNR: ' in proc.stderr
    assert 'End of training.' in proc.stderr
    proc = _cli(tmp_path, '-p', 'val', UCDIR_TPU_NO_FUSED_TAIL='1')
    assert proc.returncode != 0
    assert 'NotImplementedError' in proc.stderr
    assert 'ROADMAP.md' in proc.stderr
