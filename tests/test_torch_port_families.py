"""Every model `define_G` builds, the port against the JAX package on the
CPU: the SR3 blocks (`FeatureWiseAffine`, `Block`, `ResnetBlock`), the AKGM
block and attention at norm_groups above 1, DY3h with `resname:
ResnetBlock`, the eight diffusion variants' sampling (NoDiffusion's refine
pass, unconditional generation; their losses and gradients in
test_torch_port_families_losses.py), LPIPS and one bf16 model (`sr.main` on an SR3-style config:
test_torch_port_families_cli.py). The same numpy
inputs and the same weights (the JAX init's through
ucdir_tpu_torch.utils.convert_jax, or the port's through convert_torch) go
to both; the draws are injected.

Tolerances: a module's output 1e-5 abs; a whole network 1e-4 abs; an LPIPS
gradient 1e-3 of its largest; sampling after 3 steps 1e-4 abs; bf16 the gate
of tests/test_torch_port_bf16.py.
"""
import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucdir_tpu.diffusion.sampler import super_resolution as jax_sr
from ucdir_tpu.diffusion.sampler import (
    unconditional_sample as jax_unconditional)
from ucdir_tpu.metrics.lpips import convert_lpips_torch as jax_convert_lpips
from ucdir_tpu.metrics.lpips import lpips_distance as jax_lpips
from ucdir_tpu.models.akgm import ResnetBlockDY3h as JaxAkgmBlock
from ucdir_tpu.models.attention import SelfAttention as JaxAttention
from ucdir_tpu.models.dy3h import DY3h as JaxDY3h
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.models.layers import Block as JaxBlock
from ucdir_tpu.models.layers import FeatureWiseAffine as JaxAffine
from ucdir_tpu.models.layers import ResnetBlock as JaxResnetBlock
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
from ucdir_tpu_torch.diffusion.base import DIFFUSIONS
from ucdir_tpu_torch.diffusion.sampler import (super_resolution,
                                               unconditional_sample)
from ucdir_tpu_torch.metrics import lpips as port_lpips
from ucdir_tpu_torch.models.akgm import ResnetBlockDY3h
from ucdir_tpu_torch.models.attention import SelfAttention
from ucdir_tpu_torch.models.dy3h import DY3h, compute_guide_maps
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.models.layers import Block, FeatureWiseAffine
from ucdir_tpu_torch.models.layers import ResnetBlock
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.utils import convert_jax
from ucdir_tpu_torch.utils.convert_jax import lpips_from_jax

from test_torch_port_slice import jax_draws

torch.set_num_threads(2)

BF = torch.bfloat16


def normal(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, atol=1e-5, rtol=0.):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def T(a):
    return torch.from_numpy(np.array(a))


def state(fn, params):
    out = {}
    fn(jax.tree_util.tree_map(np.asarray, params), '', out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def injected(draws):
    it = iter(draws)
    return lambda shape: T(next(it))


# ---- the SR3 blocks and GroupNorm(G)
@pytest.mark.parametrize('affine', [False, True])
def test_feature_wise_affine(rng, affine):
    x, emb = normal(rng, 2, 5, 6, 16), normal(rng, 2, 12)
    jm = JaxAffine(16, affine)
    params = jm.init(jax.random.PRNGKey(0), x, emb)['params']
    want = jm.apply({'params': params}, x, emb)
    pm = FeatureWiseAffine(12, 16, affine)
    out = {}
    convert_jax._kernel_bias(
        jax.tree_util.tree_map(np.asarray, params['noise_func']),
        'noise_func.0.', convert_jax._dense, out)
    pm.load_state_dict({k: T(v) for k, v in out.items()}, strict=True)
    with torch.no_grad():
        close(pm(T(x), T(emb)), want)


def _block_state(params):
    out = {}
    p = jax.tree_util.tree_map(np.asarray, params)
    convert_jax._norm(p['norm'], 'block.0.', out)
    convert_jax._kernel_bias(p['conv'], 'block.3.', convert_jax._conv, out)
    return {k: T(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize('groups', [1, 8])
def test_block(rng, groups):
    x = normal(rng, 2, 9, 11, 16, scale=1.0) + 0.3
    jm = JaxBlock(24, groups=groups)
    params = jm.init(jax.random.PRNGKey(1), x)['params']
    want = jm.apply({'params': params}, x)
    pm = Block(16, 24, groups=groups)
    pm.load_state_dict(_block_state(params), strict=True)
    with torch.no_grad():
        close(pm(T(x)), want)


@pytest.mark.parametrize('dim,dim_out', [(16, 16), (24, 16)])
def test_resnet_block(rng, dim, dim_out):
    x, temb = normal(rng, 2, 8, 12, dim), normal(rng, 2, 16)
    jm = JaxResnetBlock(dim, dim_out, nl_emb_dim=16, dropout=0.1,
                        norm_groups=8)
    params = jm.init(jax.random.PRNGKey(2), x, temb)['params']
    want = jm.apply({'params': params}, x, temb)
    pm = ResnetBlock(dim, dim_out, 16, dropout=0.1, norm_groups=8).eval()
    pm.load_state_dict(state(convert_jax._res_block, params), strict=True)
    with torch.no_grad():
        close(pm(T(x), T(temb)), want)


@pytest.mark.parametrize('groups', [2, 8])
@pytest.mark.parametrize('dim,dim_out', [(16, 16), (32, 16)])
def test_akgm_block_norm_groups(rng, groups, dim, dim_out):
    """GroupNorm(G), K2 with swish and no fold, GroupNorm(G), K1 with no
    fold; no statistics come out of the block."""
    B, H, W = 2, 12, 16
    x, temb = normal(rng, B, H, W, dim), normal(rng, B, 16)
    guide = normal(rng, B, 2 * H, 2 * W, 3)
    jm = JaxAkgmBlock(dim, dim_out, nl_emb_dim=16, norm_groups=groups)
    params = jm.init(jax.random.PRNGKey(3), x, temb, guide)['params']
    want = jm.apply({'params': params}, x, temb, guide)
    pm = ResnetBlockDY3h(dim, dim_out, 16, norm_groups=groups)
    pm.load_state_dict(state(convert_jax._res_block, params), strict=True)
    with torch.no_grad():
        got, stats = pm(T(x), T(temb), T(guide))
    assert stats is None
    close(got, want)


@pytest.mark.parametrize('groups', [2, 8])
def test_self_attention_norm_groups(rng, groups):
    x = normal(rng, 2, 6, 7, 16) + 0.2
    jm = JaxAttention(16, norm_groups=groups)
    params = jm.init(jax.random.PRNGKey(4), x)['params']
    want = jm.apply({'params': params}, x)
    pm = SelfAttention(16, norm_groups=groups)
    pm.load_state_dict(state(convert_jax._attention, params), strict=True)
    with torch.no_grad():
        close(pm(T(x)), want)


DY3H_SR3 = dict(in_channel=6, out_channel=3, inner_channel=16,
                channel_mults=(1, 2), attn_res=(16,), res_blocks=1,
                dropout=0.1, norm_groups=8, image_size=32)


@pytest.mark.parametrize('resname', ['ResnetBlock', 'ResnetBlockDY3h'])
def test_dy3h_resname_and_norm_groups(rng, resname):
    """DY3h of SR3's blocks (no guide: no guide maps) and of AKGM blocks, at
    norm_groups 8, against the JAX network."""
    cfg = dict(DY3H_SR3, resname=resname)
    jm = JaxDY3h(**cfg)
    x = normal(rng, 2, 32, 32, 6)
    nl = rng.uniform(0.3, 0.9, (2, 1)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), x, nl,
                              x[..., :3])['params']
    want = jax.jit(jm.apply)({'params': params}, x, nl, x[..., :3])
    pm = DY3h(**cfg).eval()
    pm.load_state_dict(state(convert_jax._dy3h, params), strict=True)
    with torch.no_grad():
        got = pm(T(x), T(nl), T(x[..., :3]))
        maps = compute_guide_maps(pm, T(x[..., :3]))
    assert (maps == {}) == (resname == 'ResnetBlock')
    close(got, want, atol=1e-4)


# ---- the eight variants
TOY_UNET = dict(inner_channel=8, channel_mults=[1, 2], res_blocks=1,
                attn_res=[], dropout=0.0)
# the SR3 baseline on SR3's blocks; the paper's ablations on DY3h's. Two
# channels a group at least: with one, GroupNorm is an instance norm, and
# the gradient of a per-channel bias before it is 0 up to rounding
SR3 = dict(resname='ResnetBlock', norm_groups=4)


def variant_opt(name, tmp_path=None, loss_type='l1', **unet):
    model = copy.deepcopy(SID_MODEL)
    model['diffusion_name'] = name
    model['diffusion']['loss_type'] = loss_type
    model['unet'].update(TOY_UNET)
    if name in ('GaussianDiffusion', 'PerceptualGaussianDiffusion'):
        model['unet'].update(SR3)
    if name == 'NoDiffusion':
        model['unet']['in_channel'] = 3
    model['unet'].update(unet)
    if name == 'PerceptualGaussianDiffusion':
        model['lpips_weights'] = lpips_file(tmp_path)
    return {'model': model}


def lpips_state(seed=0):
    """Random weights in the layout of a torch lpips.LPIPS(net='alex')
    state dict, the scaling layer's buffers included."""
    g = torch.Generator().manual_seed(seed)
    sd = {'scaling_layer.shift': torch.tensor([-.030, -.088, -.188])[
        None, :, None, None],
        'scaling_layer.scale': torch.tensor([.458, .448, .450])[
            None, :, None, None]}
    cin = 3
    for (cout, k, _, _), (sl, idx) in zip(
            port_lpips._ALEX_CFG, ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))):
        sd['net.slice%d.%d.weight' % (sl, idx)] = (
            torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** .5)
        sd['net.slice%d.%d.bias' % (sl, idx)] = 0.1 * torch.randn(
            cout, generator=g)
        cin = cout
    for i, (cout, _, _, _) in enumerate(port_lpips._ALEX_CFG):
        sd['lin%d.model.1.weight' % i] = torch.rand(1, cout, 1, 1,
                                                    generator=g)
    return sd


def lpips_file(tmp_path):
    path = os.path.join(str(tmp_path), 'lpips_alex.pth')
    torch.save(lpips_state(), path)
    return path


def variant_pair(name, tmp_path, loss_type='l1'):
    """(the port's model with random weights, the JAX module, its
    params): the same weights on both sides."""
    opt = variant_opt(name, tmp_path, loss_type)
    torch.manual_seed(1)
    model = define_G(opt).eval()
    return model, jax_define_G(opt), convert_state_dict(model.state_dict())


def toy_batch(rng, size):
    hr, sr, noise = (normal(rng, 2, size, size, 3) for _ in range(3))
    gammas = rng.uniform(0.3, 0.95, (2, 1)).astype(np.float32)
    return {'HR': hr * 0.6, 'SR': sr * 0.3}, gammas, noise


@pytest.mark.parametrize('name', sorted(DIFFUSIONS))
def test_super_resolution(rng, tmp_path, name):
    """Restoration with 3 DDPM steps and the JAX sampler's draws, or
    NoDiffusion's refine pass, against the JAX package's super_resolution:
    the result, initx (None without a predictor) and the snapshots."""
    model, jm, params = variant_pair(name, tmp_path)
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=3)
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(functools.partial(
        jax_sr, jm, sched=jax_make_schedule(sched_opt), continous=True))(
        {'params': params}, x_in=x, key=key)
    got = super_resolution(model, make_schedule(sched_opt), T(x),
                           noise=injected(jax_draws(key, x.shape, 3)),
                           continous=True)
    assert len(got) == len(want) == 3
    assert (got[1] is None) == (want[1] is None) == (
        not model.has_predictor)
    for g, w in zip(got, want):
        if w is not None:
            assert tuple(g.shape) == tuple(np.shape(w))
            close(g, w, atol=1e-4)


def test_unconditional_sample(rng):
    """GaussianDiffusion with conditional: false and SR3's blocks: 3 steps
    from noise against the JAX package's unconditional_sample; then the same
    model with AKGM blocks, guided by the noisy image itself."""
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=3)
    key = jax.random.PRNGKey(9)
    shape = (2, 16, 16, 3)
    for unet in (SR3, dict(resname='ResnetBlockDY3h', norm_groups=1)):
        opt = variant_opt('GaussianDiffusion', in_channel=3, **unet)
        opt['model']['diffusion'].update(conditional=False, image_size=16)
        torch.manual_seed(2)
        model = define_G(opt).eval()
        jm = jax_define_G(opt)
        params = convert_state_dict(model.state_dict())
        want_img, want_snaps = jax.jit(lambda v, k: jax_unconditional(
            jm, v, jax_make_schedule(sched_opt), shape, k, continous=True))(
            {'params': params}, key)
        img, snaps = unconditional_sample(
            model, make_schedule(sched_opt), shape,
            noise=injected(jax_draws(key, shape, 3)), continous=True)
        assert snaps.shape == (4,) + shape
        close(img, want_img, atol=1e-4)
        close(snaps, want_snaps, atol=1e-4)


def test_trainer_sample_is_unconditional_sample(rng):
    """Trainer.sample draws the config's image_size and channels from the
    trainer's generator (or injected draws) under the current schedule and
    keeps the images, or the snapshots, in SR and in the `sample` visuals."""
    from ucdir_tpu_torch.trainer import Trainer
    opt = variant_opt('GaussianDiffusion', in_channel=3, **SR3)
    opt['model']['diffusion'].update(conditional=False, image_size=16)
    opt.update(phase='val', path={'resume_state': None},
               train={'ema_scheduler': {'use': True}})
    opt['model']['beta_schedule']['val'] = dict(SID_VAL_SCHEDULE,
                                                n_timestep=3)
    trainer = Trainer(opt, device='cpu', seed=3)
    draws = [normal(rng, 2, 16, 16, 3, scale=1.0) for _ in range(4)]
    got = trainer.sample(batch_size=2, continous=True,
                         noise=injected(draws))
    assert got.shape == (4, 2, 16, 16, 3)
    assert trainer.get_current_visuals(sample=True)['SAM'] is got
    want = unconditional_sample(trainer.model,
                                trainer.schedules['val'], (2, 16, 16, 3),
                                noise=injected(draws), continous=True)[1]
    close(got, want, atol=0)
    assert trainer.sample().shape == (1, 16, 16, 3)


@pytest.mark.parametrize('name', sorted(DIFFUSIONS))
def test_bf16_train_step_of_every_variant(rng, tmp_path, name):
    """Each variant's loss through the bf16 `torch.func.functional_call` of
    the train step: finite, float32, its masters and gradients float32, and
    within bf16's reach of the float32 step on the same draws; NoDiffusion
    at its constant noise level whatever gammas are injected."""
    from ucdir_tpu_torch.train import step_loss
    model = variant_pair(name, tmp_path)[0]
    batch, gammas, noise = toy_batch(
        rng, 32 if name == 'PerceptualGaussianDiffusion' else 16)
    sched = make_schedule(SID_MODEL['beta_schedule']['train'])
    args = ({k: T(v) for k, v in batch.items()},)
    draws = {'gammas': T(gammas), 'noise': T(noise)}
    loss = step_loss(model, sched, *args, draws=draws, compute_dtype=BF)
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in model.parameters() if p.grad is not None)
    with torch.no_grad():
        want = step_loss(model, sched, *args, draws=draws)
    assert abs(loss.item() - want.item()) <= 0.02 * abs(want.item())
    if name == 'NoDiffusion':
        other = dict(draws, gammas=draws['gammas'] * 0.5)
        with torch.no_grad():
            assert step_loss(model, sched, *args, draws=other) == want


@pytest.mark.parametrize('name', sorted(DIFFUSIONS))
def test_trainer_trains_and_restores_every_variant(rng, tmp_path, name):
    """Each variant through the Trainer: two optimize_parameters (dropout
    on, the draws from the trainer's step generator) change the weights and
    log a finite loss; test() restores with 2 DDPM steps (NoDiffusion: its
    refine pass) and keeps initx exactly where the variant has a
    predictor."""
    from ucdir_tpu_torch.trainer import Trainer
    opt = variant_opt(name, tmp_path)
    opt['model']['unet']['dropout'] = 0.1
    opt.update(phase='train', path={'resume_state': None},
               train={'optimizer': {'type': 'adamw', 'lr': 1e-4},
                      'ema_scheduler': {'use': False}})
    trainer = Trainer(opt, device='cpu', seed=5)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    size = 32 if name == 'PerceptualGaussianDiffusion' else 16
    batch, _, _ = toy_batch(rng, size)
    for _ in range(2):
        trainer.feed_data(batch)
        trainer.optimize_parameters()
        assert np.isfinite(trainer.get_current_log()['l_pix'])
    assert any(not torch.equal(v, before[k])
               for k, v in trainer.model.state_dict().items())
    trainer.set_new_noise_schedule(dict(SID_VAL_SCHEDULE, n_timestep=2),
                                   'val', force=True)
    trainer.feed_data({k: v[:1] for k, v in batch.items()})
    trainer.test(continous=True)
    assert trainer.model.training
    frames = 2 if name == 'NoDiffusion' else 3
    assert trainer.SR.shape == (frames, size, size, 3)
    assert np.isfinite(trainer.SR).all()
    assert (trainer.pre_initx is None) == (not trainer.model.has_predictor)


def test_resnet_block_dropout_on_ranks_is_one_process(rng):
    """In train() mode every ResnetBlock's dropout and the head's draw their
    masks from the generator in the layers' order; a DataShard of it draws
    the global batch's masks and keeps the rank's rows, so each rank's
    output is its rows of the one-process output."""
    from ucdir_tpu_torch.parallel.mesh import DataShard
    torch.manual_seed(4)
    net = DY3h(**dict(DY3H_SR3, resname='ResnetBlock')).train()
    x = T(normal(rng, 4, 32, 32, 6))
    nl = T(rng.uniform(0.3, 0.9, (4, 1)).astype(np.float32))
    with torch.no_grad():
        whole = net(x, nl, x[..., :3],
                    dropout_generator=torch.Generator().manual_seed(9))
        for r in range(2):
            rows = slice(2 * r, 2 * r + 2)
            part = net(x[rows], nl[rows], x[rows, ..., :3],
                       dropout_generator=DataShard(
                           torch.Generator().manual_seed(9), r, 2))
            # another batch size sums the convolutions in another order
            close(part, whole[rows], atol=1e-5)
        again = net(x, nl, x[..., :3],
                    dropout_generator=torch.Generator().manual_seed(10))
    assert (again - whole).abs().max() > 1e-3    # the masks are drawn


# ---- LPIPS
def test_lpips_matches_jax_with_its_gradient(rng, tmp_path):
    """The AlexNet LPIPS on random weights in the lpips state-dict layout,
    converted by each package's convert_lpips_torch, and its gradient in the
    first input; the JAX .npz layout loads to the same weights; without
    weights make_lpips raises the JAX package's message."""
    sd = lpips_state(3)
    wj = jax_convert_lpips(sd)
    wp = port_lpips.convert_lpips_torch(sd)
    x = rng.uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    y = np.clip(x + normal(rng, *x.shape, scale=0.2), -1, 1)
    want, want_dx = jax.jit(jax.value_and_grad(
        lambda a: jnp.sum(jax_lpips(a, y, wj) * jnp.array([1., 2.]))))(x)
    xt = T(x).requires_grad_(True)
    got = port_lpips.lpips_distance(xt, T(y), wp)
    (got * torch.tensor([1., 2.])).sum().backward()
    got = got.detach()
    close((got * torch.tensor([1., 2.])).sum(), want, atol=0, rtol=1e-5)
    close(got, jax.jit(jax_lpips)(x, y, wj), atol=1e-5)
    close(xt.grad, want_dx, atol=1e-3 * np.abs(want_dx).max())
    npz = os.path.join(str(tmp_path), 'lpips.npz')
    np.savez(npz, **wj)
    for k, v in port_lpips.load_lpips_weights(npz).items():
        close(v, wp[k], atol=0)
    assert set(lpips_from_jax(wj)) == set(wp)
    with pytest.raises(RuntimeError, match='UCDIR_TPU_LPIPS_WEIGHTS'):
        port_lpips.make_lpips(os.path.join(str(tmp_path), 'missing.pth'))


# ---- bf16
def test_bf16_norm_groups_model_matches_jax(rng):
    """The AKGM model at norm_groups 8 restored in bf16, against the JAX
    package's bf16 super_resolution: the gate of test_torch_port_bf16.py
    (sr 2.5e-3 mean abs and 3e-2 max abs, initx 2^-8), and within 0.05
    mean abs of its own float32."""
    opt = variant_opt('ResiGaussianGuideDY', inner_channel=16, norm_groups=8)
    torch.manual_seed(0)
    model = define_G(opt).eval()
    params = convert_state_dict(model.state_dict())
    jm = jax_define_G(opt)
    sched_opt = dict(SID_VAL_SCHEDULE, n_timestep=3)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_sr, want_initx = jax.jit(lambda v, xx, k: jax_sr(
        jm, v, jax_make_schedule(sched_opt), xx, k,
        compute_dtype=jnp.bfloat16))({'params': params}, x, key)

    def run(dtype):
        return super_resolution(
            model, make_schedule(sched_opt), T(x),
            noise=injected(jax_draws(key, x.shape, 3)), compute_dtype=dtype)

    sr, initx = run(BF)
    assert sr.dtype == initx.dtype == torch.float32
    err = np.abs(sr.numpy() - np.asarray(want_sr))
    assert err.mean() <= 2.5e-3 and err.max() <= 3e-2, (err.mean(),
                                                        err.max())
    assert np.abs(initx.numpy() - np.asarray(want_initx)).max() <= 2. ** -8
    assert (sr - run(None)[0]).abs().mean().item() < 0.05
