"""The port's training slice (ucdir_tpu_torch.train, trainer, sr -p train) on
the CPU against the JAX package: optimizer steps on injected draws, the EMA
gate, finetune_norm, the checkpoint triple, the CLI, and that the port loads
nothing of JAX or of the JAX package.

Tolerances are stated at each comparison; float32 on both sides.
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

from ucdir_tpu.diffusion.sampler import (
    sample_continuous_gamma as jax_sample_gamma)
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train import (create_train_state as jax_create_state,
                             make_optimizer as jax_make_optimizer,
                             make_train_step)
from ucdir_tpu.train.optim import finetune_mask, zero_finetune_params
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_MODEL
from ucdir_tpu_torch.diffusion.sampler import sample_continuous_gamma
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.train import (create_train_state, make_optimizer,
                                   train_step)
from ucdir_tpu_torch.train.optim import finetune_select
from ucdir_tpu_torch.trainer import Trainer, TrainerBNoise, create_model
from ucdir_tpu_torch.utils import checkpoint as ckpt_util
from ucdir_tpu_torch.utils.convert_jax import from_jax_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED_OPT = dict(schedule='linear', n_timestep=10, linear_start=1e-6,
                 linear_end=1e-2)
LR = 1e-4
EMA_OPT = {'use': True, 'ema_decay': 0.5, 'step_start_ema': 1,
           'update_ema_every': 1}


def toy_opt(dropout=0.0):
    """The SID model at toy size: 2 levels, C / G = 2 and 4, attention in
    mid_0. dropout 0 where both frameworks run in train mode: they draw
    different masks."""
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(inner_channel=16, channel_mults=[1, 2],
                         res_blocks=1, attn_res=[], dropout=dropout)
    return {'model': model}


def toy_batch(rng, B=2, size=32):
    hr = rng.uniform(-0.8, 0.8, (B, size, size, 3)).astype(np.float32)
    sr = (0.2 * hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
    return {'HR': hr, 'SR': sr}


def jax_draws(key, sched, shape):
    """The gammas and noise make_train_step draws from `key`."""
    k_gamma, k_noise, _ = jax.random.split(key, 3)
    return (np.array(jax_sample_gamma(k_gamma, sched, shape[0])),
            np.array(jax.random.normal(k_noise, shape, jnp.float32)))


def run_both(rng, kind, steps=3, finetune=None):
    """`steps` optimizer steps of both frameworks from the same weights, on
    the same batch, gammas and noise. Returns per-step losses and the final
    (params, ema) of each side under the port's names."""
    opt = toy_opt()
    torch.manual_seed(2)
    model = define_G(opt).train()
    params = convert_state_dict(model.state_dict())
    batch = toy_batch(rng)
    optimizer_opt = {'type': kind, 'lr': LR}

    jm, jsched = jax_define_G(opt), jax_make_schedule(SCHED_OPT)
    mask = None
    if finetune:
        mask = finetune_mask(params, finetune)
        params = zero_finetune_params(params, mask)
    jstate = jax_create_state(params, jax_make_optimizer(optimizer_opt,
                                                         mask=mask), EMA_OPT)
    jstep = make_train_step(jm, jsched, donate=False)

    chosen = (finetune_select(model, finetune) if finetune
              else model.parameters())
    state = create_train_state(model, make_optimizer(chosen, optimizer_opt),
                               EMA_OPT)
    sched = make_schedule(SCHED_OPT)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    losses = []
    for key in jax.random.split(jax.random.PRNGKey(11), steps):
        gammas, noise = jax_draws(key, jsched, batch['HR'].shape)
        jstate, m = jstep(jstate, jbatch, key)
        loss = train_step(state, sched, tbatch, draws={
            'gammas': torch.from_numpy(gammas),
            'noise': torch.from_numpy(noise)})
        losses.append((loss.item(), float(m['l_pix'])))
    assert state.step == int(jstate.step) == steps
    port = ({k: v.detach().numpy() for k, v in model.state_dict().items()},
            {k: v.numpy() for k, v in state.ema_params.items()})
    ref = tuple({k: v.numpy() for k, v in from_jax_params(p).items()}
                for p in (jstate.params, jstate.ema_params))
    return losses, port, ref, model


def check_losses(losses):
    """The first loss (same weights) within 1e-5 rel, the later ones within
    2e-4 rel. Adam's and Lion's updates are lr * sign(gradient) whatever the
    gradient's size, so a gradient inside the rounding noise steps either
    way, and the JAX side's own result changes from run to run when the host
    is loaded (its later losses by up to 5.5e-5 rel over 30 readings, while
    the port's stay bit-identical)."""
    for i, (got, want) in enumerate(losses):
        np.testing.assert_allclose(got, want, rtol=1e-5 if i == 0 else 2e-4)


def check_params(got, want, steps, names=None):
    """Parameters after `steps` sign-like updates of size lr: any element
    within 2 * lr * steps (the most that steps the other way can give), and
    the denoiser's elements within 0.1 lr on average (readings: 0.00005 lr
    on a quiet host, up to 0.015 lr on a loaded one). The predictor's deep
    layers get gradients of 1e-10 and less at this size, whose signs are
    rounding noise in either framework, so only the hard bound holds them;
    test_p_losses_and_gradients_match_jax holds the predictor's gradients
    and test_optimizers_match_optax_on_the_same_gradients the update."""
    total = count = 0
    for name in names or want:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= 2 * LR * steps * 1.1 + 1e-7, name
        if name.startswith('denoise_fn.'):
            total, count = total + diff.sum(), count + diff.size
    assert count and total / count <= 0.1 * LR, total / count


@pytest.mark.parametrize('kind', ['adamw', 'adam', 'lion'])
def test_train_steps_match_jax(rng, kind):
    """Three optimizer steps against make_train_step on injected draws: the
    loss of each step and the parameters after (tolerances: check_losses,
    check_params)."""
    losses, (got, got_ema), (want, want_ema), _ = run_both(rng, kind)
    check_losses(losses)
    assert got.keys() == want.keys()
    check_params(got, want, 3)


@pytest.mark.parametrize('kind', ['adamw', 'adam', 'lion'])
def test_optimizers_match_optax_on_the_same_gradients(rng, kind):
    """Three updates of make_optimizer's optimizer against the JAX package's
    optax one on identical injected gradients: within 1e-6 abs, 1% of one
    update (lr) and about 4 float32 ulp of the largest weights, which holds
    the betas, eps, bias correction and weight decay. A gradient of exactly 0
    keeps Lion's sign at 0 on both sides."""
    import optax
    shapes = {'a': (5, 7), 'b': (16,), 'c': (3, 3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[1]['b'][:4] = 0.0
    tx = jax_make_optimizer({'type': kind, 'lr': LR})
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    leaves = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in params.items()}
    optimizer = make_optimizer(leaves.values(), {'type': kind, 'lr': LR})
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in leaves.items():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
    for k, p in leaves.items():
        assert np.abs(p.detach().numpy() - params[k]).max() > 2 * LR
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_ema_gate_matches_jax(rng):
    """The shadow starts as the initial weights and blends only when the
    pre-increment step is > step_start_ema (1 here): of three steps only the
    last blends, with decay 0.5."""
    torch.manual_seed(2)
    init = {k: v.numpy().copy()
            for k, v in define_G(toy_opt()).state_dict().items()}
    _, (got, got_ema), (_, want_ema), _ = run_both(rng, 'adamw')
    for name, w in want_ema.items():
        # half of what the parameters themselves may differ by (decay 0.5)
        np.testing.assert_allclose(got_ema[name], w, rtol=0, atol=3.3 * LR,
                                   err_msg=name)
        np.testing.assert_allclose(
            got_ema[name], 0.5 * init[name] + 0.5 * got[name], rtol=0,
            atol=1e-7, err_msg=name)
    state = create_train_state(define_G(toy_opt()), None,
                               {'use': True, 'step_start_ema': 5,
                                'update_ema_every': 2})
    blended = []
    for state.step in range(10):
        blended.append(state.update_ema())
    assert blended == [False] * 6 + [True, False, True, False]
    state.use_ema, state.step = False, 8
    assert not state.update_ema()


def test_finetune_norm_matches_jax(rng):
    """finetune_norm: every parameter frozen, those whose name contains the
    substring zeroed and optimized. Frozen tensors stay bit-identical; the
    chosen ones follow the JAX package's masked optimizer (tolerances:
    check_losses, check_params)."""
    torch.manual_seed(2)
    init = {k: v.numpy().copy()
            for k, v in define_G(toy_opt()).state_dict().items()}
    losses, (got, _), (want, _), model = run_both(rng, 'adamw', steps=2,
                                                   finetune='norm1')
    check_losses(losses)
    chosen = [n for n in got if 'norm1' in n]
    assert chosen and len(chosen) < len(got)
    for name, p in model.named_parameters():
        assert p.requires_grad == ('norm1' in name), name
    check_params(got, want, 2, names=chosen)
    for name in got:
        if name in chosen:
            assert np.abs(got[name]).max() > 0, name   # moved off its zero
        else:
            np.testing.assert_array_equal(got[name], init[name], name)
    with pytest.raises(ValueError, match='no parameter'):
        finetune_select(define_G(toy_opt()), 'transformer')


def test_clip_norm_scales_the_gradients(rng):
    """clip_norm: the step is taken on gradients scaled to the global norm
    (reference model.py:111-112)."""
    torch.manual_seed(3)
    model = define_G(toy_opt()).train()
    state = create_train_state(
        model, make_optimizer(model.parameters(), {'type': 'adamw'}),
        clip_norm=0.05)
    batch = {k: torch.from_numpy(v) for k, v in toy_batch(rng).items()}
    train_step(state, make_schedule(SCHED_OPT), batch,
               generator=torch.Generator().manual_seed(0))
    total = torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters()))
    assert abs(total.item() - 0.05) < 1e-5


def test_sample_continuous_gamma_matches_jax():
    """Same t and uniforms -> the same gammas (exact: one multiply-add on the
    same float32 table); generator draws stay inside [table[t-1], table[t]]."""
    jsched, sched = jax_make_schedule(SCHED_OPT), make_schedule(SCHED_OPT)
    key = jax.random.PRNGKey(5)
    k_t, k_g = jax.random.split(key)
    t = int(jax.random.randint(k_t, (), 1, 11))
    u = np.array(jax.random.uniform(k_g, (4, 1), dtype=jnp.float32))
    want = np.asarray(jax_sample_gamma(key, jsched, 4))
    got = sample_continuous_gamma(sched, 4, t=t, u=torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    gen = torch.Generator().manual_seed(0)
    table = sched.sqrt_alphas_cumprod_prev
    for _ in range(20):
        g = sample_continuous_gamma(sched, 3, gen)
        assert g.shape == (3, 1)
        assert any(table[i] <= g.min() and g.max() <= table[i - 1]
                   for i in range(1, 11))


def trainer_opt(tmp_path, phase='train', resume=None):
    return {'phase': phase, 'model': toy_opt(dropout=0.1)['model'],
            'path': {'resume_state': resume,
                     'checkpoint': str(tmp_path / 'checkpoint')},
            'train': {'optimizer': {'type': 'adamw', 'lr': 1e-3},
                      'ema_scheduler': dict(EMA_OPT)}}


def test_trainer_trains_validates_and_round_trips_checkpoints(rng, tmp_path):
    """The train half of Trainer: steps reduce the loss on a fixed batch,
    validation runs with the live weights and leaves train mode on, the
    triple I{it}_E{ep}_{gen,gen_ema,opt}.pth restores weights, shadow,
    optimizer state and step bit for bit, a resumed trainer repeats the next
    step exactly, and the val phase loads the EMA file."""
    opt = trainer_opt(tmp_path)
    trainer = Trainer(opt, device='cpu', seed=4)
    batch = toy_batch(rng)
    trainer.feed_data(batch)
    losses = []
    for _ in range(8):
        trainer.optimize_parameters()
        losses.append(trainer.get_current_log()['l_pix'])
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert trainer.iter == trainer.state.step == 8

    trainer.set_new_noise_schedule(dict(SCHED_OPT, n_timestep=2), 'val')
    trainer.feed_data({k: v[:1] for k, v in batch.items()})
    trainer.test(continous=False)
    assert trainer.get_current_visuals()['SR'].shape == (1, 32, 32, 3)
    assert np.isfinite(trainer.SR).all() and trainer.model.training
    trainer.set_new_noise_schedule(opt['model']['beta_schedule']['train'],
                                   'train')

    prefix = trainer.save_network(3, 8)
    assert prefix.endswith('I8_E3')
    for suffix in ('_gen.pth', '_gen_ema.pth', '_opt.pth'):
        assert os.path.isfile(prefix + suffix)
    resumed = Trainer(trainer_opt(tmp_path, resume=prefix), device='cpu',
                      seed=4)
    assert (resumed.iter, resumed.begin_step, resumed.begin_epoch) == (8, 8, 3)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
        assert torch.equal(resumed.state.ema_params[k],
                           trainer.state.ema_params[k]), k
    for t in (trainer, resumed):
        t.feed_data(batch)
        t.optimize_parameters()
    assert resumed.log_dict['l_pix'] == trainer.log_dict['l_pix']
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k

    val = Trainer(trainer_opt(tmp_path, 'val', resume=prefix), device='cpu')
    ema = torch.load(prefix + '_gen_ema.pth', weights_only=True)
    for k, v in val.model.state_dict().items():
        assert torch.equal(v, ema[k]), k
    assert not val.model.training
    with pytest.raises(FileNotFoundError):
        ckpt_util.restore_state(str(tmp_path / 'missing'), trainer.state)


@pytest.mark.parametrize('name, cls', [(None, Trainer), ('DDPM', Trainer),
                                       ('DDPM_bnoise', TrainerBNoise)])
def test_create_model_builds_the_trainer_model_name_names(tmp_path, name,
                                                          cls):
    """create_model picks the trainer by opt['model']['name'] as the JAX
    package's does (no name: DDPM)."""
    opt = trainer_opt(tmp_path)
    if name is not None:
        opt['model']['name'] = name
    assert type(create_model(opt, device='cpu', seed=1)) is cls


@pytest.mark.parametrize('name', ['DDPM_realsr', 'DDPM_unknown'])
def test_create_model_refuses_names_it_does_not_build(tmp_path, name):
    """DDPM_realsr is not ported and an unknown name is no model: both raise
    (the JAX package raises KeyError on the unknown one) rather than train
    another model."""
    opt = trainer_opt(tmp_path)
    opt['model']['name'] = name
    with pytest.raises(NotImplementedError, match=name):
        create_model(opt, device='cpu')


def test_bnoise_adds_its_draws_to_the_degraded_input(rng, tmp_path,
                                                     monkeypatch):
    """TrainerBNoise.feed_data gives exactly SR + draws * 2 * 50/255 for
    injected draws and leaves HR alone; the draws come from the trainer's
    own seeded generator, the same for the same seed, not from torch's
    global state."""
    opt = trainer_opt(tmp_path)
    opt['model']['name'] = 'DDPM_bnoise'
    batch = toy_batch(rng)
    draws = rng.standard_normal(batch['SR'].shape).astype(np.float32)
    trainer = create_model(opt, device='cpu', seed=3)
    monkeypatch.setattr(trainer, 'draw_noise', lambda shape: draws)
    trainer.feed_data(batch)
    want = batch['SR'].astype(np.float32) + draws * 2 * (50. / 255.)
    np.testing.assert_array_equal(trainer.data['SR'], want)
    np.testing.assert_array_equal(trainer.data['HR'], batch['HR'])
    monkeypatch.undo()

    def noise_of(seed):
        t = create_model(opt, device='cpu', seed=seed)
        torch.manual_seed(seed + 100)   # the global state plays no part
        t.feed_data(batch)
        return t.data['SR'] - batch['SR'].astype(np.float32)

    a, b = noise_of(3), noise_of(3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, noise_of(4))
    assert 0.2 < np.std(a) < 0.6      # 2 * 50/255 = 0.39


def test_latest_checkpoint_keeps_the_step(tmp_path):
    """`I_Elatest` names neither iteration nor epoch: the step comes back
    from the opt file, the epoch as 0."""
    model = define_G(toy_opt())
    state = create_train_state(
        model, make_optimizer(model.parameters(), {'type': 'lion'}))
    state.step = 17
    prefix = ckpt_util.save_state(str(tmp_path), 'latest', '', state)
    assert os.path.basename(prefix) == 'I_Elatest'
    state.step = 0
    assert ckpt_util.restore_state(prefix, state) == (17, 0)


def _write_pairs(root, n=2, size=40):
    from PIL import Image
    g = np.random.default_rng(0)
    for sub in ('input', 'target'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        clean = g.integers(0, 256, (size, size, 3), dtype=np.uint8)
        noisy = np.clip(clean + g.normal(0, 25, clean.shape), 0, 255)
        Image.fromarray(clean).save(os.path.join(root, 'target', f'{i}.png'))
        Image.fromarray(noisy.astype(np.uint8)).save(
            os.path.join(root, 'input', f'{i}.png'))


def _tiny_yaml(tmp_path):
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
    cfg['datasets']['train']['data_args']['crop_size'] = 32
    cfg['train']['n_iter'] = 4
    (tmp_path / 'tiny.yaml').write_text(yaml.safe_dump(cfg))


# after sr.main: nothing of JAX or of the JAX package was imported
_CLI = (
    'import sys\n'
    'from ucdir_tpu_torch import sr\n'
    'sr.main(sys.argv[1:])\n'
    'bad = sorted(k for k in sys.modules if k.split(".")[0] in\n'
    '             ("ucdir_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))\n'
    'assert not bad, bad\n')


def _cli(tmp_path, *args):
    proc = subprocess.run(
        [sys.executable, '-c', _CLI, '-c', 'tiny.yaml', '-debug', '--device',
         'cpu', *args], cwd=tmp_path, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=ROOT,
                              OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stderr


def test_cli_train_then_val_on_cpu_loads_no_jax(tmp_path):
    """`-p train` on generated pairs for 4 iterations (-debug: print and
    validate every 2, save every 3), then `-p val` from the triple it saved;
    after either, sys.modules holds nothing of ucdir_tpu, jax, jaxlib, flax,
    optax or orbax."""
    _tiny_yaml(tmp_path)
    log = _cli(tmp_path, '-p', 'train')
    assert log.count('l_pix: ') == 2
    assert log.count('# Validation # PSNR: ') == 2
    assert 'End of training.' in log
    saved = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
             for f in fs if f.endswith('.pth')]
    assert sorted(os.path.basename(f) for f in saved) == [
        'I_Elatest_gen.pth', 'I_Elatest_gen_ema.pth', 'I_Elatest_opt.pth']
    assert torch.load(saved[0].rsplit('_', 1)[0].replace('_gen', '')
                      + '_opt.pth', weights_only=True)['step'] == 3
    prefix = os.path.join(os.path.dirname(saved[0]), 'I_Elatest')
    log = _cli(tmp_path, '-p', 'val', '--checkpoint', prefix)
    assert 'Loading pretrained model for G [%s_gen_ema.pth]' % prefix in log
    assert '# Validation # PSNR: ' in log and '# Validation # SSIM: ' in log


def test_cli_trains_the_bnoise_model_on_cpu_loads_no_jax(tmp_path):
    """A DDPM_bnoise config trains through `-p train` at toy size on the
    CPU, as TrainerBNoise (the noise added to every fed batch), with nothing
    of JAX or of the JAX package imported."""
    _tiny_yaml(tmp_path)
    cfg = yaml.safe_load((tmp_path / 'tiny.yaml').read_text())
    cfg['model']['name'] = 'DDPM_bnoise'
    cfg['train']['n_iter'] = 2
    (tmp_path / 'tiny.yaml').write_text(yaml.safe_dump(cfg))
    log = _cli(tmp_path, '-p', 'train')
    assert log.count('l_pix: ') == 1
    assert 'End of training.' in log


def test_cli_train_refuses_a_missing_card():
    from ucdir_tpu_torch import sr
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='--device cpu'):
        sr.main(['-p', 'train'])


def test_unported_dataset_kinds_point_at_the_roadmap():
    from ucdir_tpu_torch.data import create_dataset
    for opt in ({'datasetname': 'RealESRGANDataset', 'data_args': {}},
                {'datasetname': 'SomethingRegistered', 'data_args': {}},
                {'dataroot': 'x'},
                {'datasetname': 'PairDataset', 'data_args': {
                    'dataroot': {'lq': '.', 'gt': '.'}, 'datatype': 'lmdb'}},
                {'datasetname': 'PairDataset', 'data_args': {
                    'dataroot': {'lq': '.', 'gt': '.'}, 'mask': 1}}):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            create_dataset(opt, 'train')


@pytest.mark.parametrize('what', ['config', 'sampler', 'metrics_core',
                                  'metrics_ssim', 'augment', 'loader'])
def test_port_copies_agree_with_the_jax_package(rng, what, tmp_path,
                                                monkeypatch):
    """The port keeps its own copies of the JAX package's jax-free modules;
    each gives the same result as its original on the same input (exact:
    the same numpy code)."""
    if what == 'config':
        from ucdir_tpu import config as theirs
        from ucdir_tpu_torch import config as ours
        monkeypatch.setattr(theirs, 'get_timestamp', lambda: 'T')
        monkeypatch.setattr(ours, 'get_timestamp', lambda: 'T')
        path = os.path.join(ROOT, 'ucdir_tpu', 'configs', 'sid.yaml')
        for kw in (dict(phase='train'), dict(phase='val', checkpoint='x'),
                   dict(phase='train', debug=True)):
            assert (ours.parse(path, num_processes=1, make_dirs=False, **kw)
                    == theirs.parse(path, num_processes=1, make_dirs=False,
                                    **kw))
    elif what == 'sampler':
        from ucdir_tpu.data.sampler import EnlargedSampler as Theirs
        from ucdir_tpu_torch.data.sampler import EnlargedSampler as Ours
        for args in ((range(10), 1, 0, 1, 0), (range(7), 2, 1, 3, 5)):
            a, b = Ours(*args), Theirs(*args)
            a.set_epoch(2), b.set_epoch(2)
            assert list(a) == list(b) and len(a) == len(b)
    elif what in ('metrics_core', 'metrics_ssim'):
        import importlib
        name = what.split('_')[1]
        theirs = importlib.import_module('ucdir_tpu.metrics.' + name)
        ours = importlib.import_module('ucdir_tpu_torch.metrics.' + name)
        x, y = (rng.integers(0, 256, (24, 20, 3)).astype(np.uint8)
                for _ in range(2))
        assert ours.calculate_psnr(x, y) == theirs.calculate_psnr(x, y)
        assert ours.calculate_ssim(x, y) == theirs.calculate_ssim(x, y)
        if name == 'core':
            t = rng.uniform(-1.2, 1.2, (3, 8, 8, 3)).astype(np.float32)
            np.testing.assert_array_equal(ours.tensor2img(t),
                                          theirs.tensor2img(t))
        else:
            assert (ours.calculate_psnr(x, y, 2, test_y_channel=True)
                    == theirs.calculate_psnr(x, y, 2, test_y_channel=True))
    elif what == 'augment':
        import random
        from ucdir_tpu.data import util as theirs
        from ucdir_tpu_torch.data import util as ours
        imgs = [rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)
                for _ in range(2)]
        for split in ('train', 'val'):
            random.seed(3), np.random.seed(3)
            want = theirs.transform_augment(imgs, split=split,
                                            min_max=(-1, 1))
            random.seed(3), np.random.seed(3)
            got = ours.transform_augment(imgs, split=split, min_max=(-1, 1))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    else:
        from ucdir_tpu import data as theirs
        from ucdir_tpu_torch import data as ours
        _write_pairs(str(tmp_path), n=5, size=24)
        opt = {'name': 'x', 'datasetname': 'PairDataset', 'batch_size': 2,
               'data_args': {'dataroot': {'lq': str(tmp_path / 'input'),
                                          'gt': str(tmp_path / 'target')},
                             'crop_size': 16, 'split': 'train'}}
        batches = []
        for mod in (ours, theirs):
            import random
            random.seed(1), np.random.seed(1)
            loader = mod.create_dataloader(mod.create_dataset(opt, 'train'),
                                           opt, 'train', seed=9)
            loader.num_workers = 1      # one thread: one order of draws
            loader.prefetch_batches = 1
            loader.set_epoch(1)
            batches.append(list(loader))
        assert len(batches[0]) == len(batches[1]) == 2
        for a, b in zip(*batches):
            assert a.keys() >= {'HR', 'SR', 'Index'}
            for k in ('HR', 'SR', 'Index'):
                np.testing.assert_array_equal(a[k], b[k])
