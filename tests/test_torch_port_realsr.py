"""The port's Real-SR path (ucdir_tpu_torch.realsr) on the CPU against the
JAX package's: the dataset's items and kernels bit for bit, the
training-pair queue under one np.random seed, the whole two-stage
degradation feed at dataset crop 128 and gt_size 64 on the same coins of
`random` and `np.random` with the JAX feed's per-sample draws injected (the
feed limit, `realsr.FEED_LIMIT`: HR within 1e-4, SR within 1e-3 mean abs
with at least 99% of its values on the same 1/255 level), the validation
feed, and one optimizer step on the fed batch (the port's own draws)."""
import os
import random
from types import MethodType, SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import ucdir_tpu.realsr as JR
import ucdir_tpu_torch.realsr as PR
from ucdir_tpu_torch.config import dict_to_nonedict
from test_torch_port_degradations import (_t, jax_gaussian_draws,
                                          jax_poisson_draws)

torch.set_num_threads(2)

CROP, GT_SIZE, QUEUE, BATCH = 128, 64, 4, 2


@pytest.fixture(scope='module')
def imnet(tmp_path_factory):
    """Generated images (some smaller than the crop: reflect-padded) and
    their txt list."""
    tmp = str(tmp_path_factory.mktemp('port_realsr'))
    root = os.path.join(tmp, 'imgs')
    os.makedirs(root)
    g = np.random.default_rng(0)
    names = []
    for i, (h, w) in enumerate(((150, 140), (128, 160), (100, 136),
                                (140, 128))):
        yy, xx = np.mgrid[0:h, 0:w] / 40.
        img = np.stack([np.sin(xx * (1 + i) + c) * np.cos(yy - c)
                        for c in range(3)], -1) * 90 + 128
        img = np.clip(img + g.normal(0, 12, img.shape), 0, 255)
        names.append('%03d.png' % i)
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(root,
                                                                names[-1]))
    txt = os.path.join(tmp, 'list.txt')
    with open(txt, 'w') as f:
        f.write('\n'.join(names))
    return {'root': root, 'txt': txt}


@pytest.mark.parametrize('split', ['train', 'val', 'test'])
@pytest.mark.parametrize('preset', ['param', 'param1'])
def test_dataset_items_and_kernels_equal(imnet, split, preset):
    for idx in range(4):
        items = []
        for mod in (JR, PR):
            random.seed(idx), np.random.seed(idx)
            items.append(mod.RealESRGANDataset(
                imnet, split=split, crop_size=CROP, param=preset)[idx])
        want, got = items
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    if split != 'test':
        assert got['gt'].shape == (CROP, CROP, 3)
        assert got['kernel1'].shape == got['sinc_kernel'].shape == (21, 21)
        assert abs(got['kernel2'].sum() - 1) < 1e-4


def test_from_image_is_the_item_of_the_loaded_image(imnet):
    from ucdir_tpu_torch.data import util as Util
    ds = PR.RealESRGANDataset(imnet, split='train', crop_size=CROP)
    random.seed(1), np.random.seed(1)
    want = ds[2]
    img = Util.to_float(Util.load_img(os.path.join(imnet['root'],
                                                   ds.hr_path[2])))
    random.seed(1), np.random.seed(1)
    got = ds.from_image(img, 2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_queue_fill_and_swap_equal():
    """Two fills, then swaps: under one np.random seed the port's queue
    returns and holds what the JAX package's does."""
    g = np.random.default_rng(3)
    queues = [SimpleNamespace(queue_size=QUEUE, queue_lr=None, queue_gt=None,
                              queue_ptr=0) for _ in range(2)]
    np.random.seed(9)
    state = np.random.get_state()
    for step in range(5):
        lq = g.random((BATCH, 4, 4, 3)).astype(np.float32)
        gt = g.random((BATCH, 16, 16, 3)).astype(np.float32)
        np.random.set_state(state)
        want = JR.TrainerRealSR._dequeue_and_enqueue(
            queues[0], jnp.asarray(lq), jnp.asarray(gt))
        np.random.set_state(state)
        got = PR.TrainerRealSR._dequeue_and_enqueue(queues[1], _t(lq),
                                                    _t(gt))
        state = np.random.get_state()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(queues[1].queue_lr.numpy(),
                                      np.asarray(queues[0].queue_lr))
        assert queues[1].queue_ptr == queues[0].queue_ptr == min(
            QUEUE, BATCH * (step + 1))
    with pytest.raises(ValueError, match='multiple'):
        PR.TrainerRealSR._dequeue_and_enqueue(
            SimpleNamespace(queue_size=5, queue_lr=None, queue_gt=None,
                            queue_ptr=0), _t(lq), _t(gt))


def _opt(tmp):
    return dict_to_nonedict({
        'name': 'realsr-tiny', 'phase': 'train', 'model': {
            'name': 'DDPM_realsr',
            'which_model_G': 'ucdir', 'unet_name': 'DY3h',
            'diffusion_name': 'ResiGaussianGuideDY',
            'unet': {'in_channel': 6, 'out_channel': 3, 'inner_channel': 8,
                     'channel_mults': [1, 2], 'attn_res': [],
                     'res_blocks': 1, 'dropout': 0.0, 'norm_groups': 1},
            'beta_schedule': {
                'train': {'schedule': 'linear', 'n_timestep': 10,
                          'linear_start': 1e-6, 'linear_end': 1e-2},
                'val': {'schedule': 'linear', 'n_timestep': 5,
                        'linear_start': 1e-6, 'linear_end': 0.4}},
            'diffusion': {'image_size': 32, 'channels': 3,
                          'conditional': True}},
        'path': {'checkpoint': tmp, 'resume_state': None},
        'datasets': {'train': {'batch_size': BATCH}},
        'train': {'n_iter': 2, 'optimizer': {'type': 'adamw', 'lr': 1e-4},
                  'ema_scheduler': {'use': False}}})


def _small(trainer):
    """The `dopt` preset at gt_size 64 and a queue of one batch: the first
    feed fills it, the second swaps."""
    trainer.dopt = dict(trainer.dopt, gt_size=GT_SIZE, queue_size=BATCH)
    trainer.queue_size = BATCH
    return trainer


@pytest.fixture(scope='module')
def trainers(tmp_path_factory):
    """The JAX package's feed on a bare object (its model is not needed),
    and the port's TrainerRealSR at toy width, both at the small preset."""
    tmp = str(tmp_path_factory.mktemp('port_realsr_ckpt'))
    from ucdir_tpu_torch.trainer import create_model
    port = create_model(_opt(tmp), device='cpu', seed=0)
    assert type(port) is PR.TrainerRealSR and port.dopt is PR.dopt
    jt = SimpleNamespace(dopt=PR.dopt, queue_lr=None, queue_gt=None,
                         queue_ptr=0, is_train=True, gt_usm_for_hr=True,
                         local_key=jax.random.PRNGKey(1))
    for name in ('feed_data', '_dequeue_and_enqueue'):
        setattr(jt, name, MethodType(getattr(JR.TrainerRealSR, name), jt))
    return _small(jt), _small(port)


def _jitted(fn, static):
    """fn under jax.jit, its `static` keyword arguments static (lists as
    tuples): the JAX feed's ops compiled once per shape, as one program
    each, instead of op by op."""
    jitted = jax.jit(fn, static_argnames=static)

    def call(*args, **kw):
        return jitted(*args, **{k: tuple(v) if isinstance(v, list) else v
                                for k, v in kw.items()})
    return call


def jit_the_jax_feed(monkeypatch):
    noise = ('gray_prob', 'clip', 'rounds')
    for name, static in (
            ('usm_sharp', ('weight', 'radius', 'sigma', 'threshold')),
            ('filter2D', ()),
            ('interpolate', ('scale_factor', 'size', 'mode')),
            ('random_add_gaussian_noise_pt', ('sigma_range',) + noise),
            ('random_add_poisson_noise_pt', ('scale_range',) + noise),
            ('diff_jpeg', ('differentiable',))):
        monkeypatch.setattr(JR, name, _jitted(getattr(JR, name), static))


def jax_feed_draws(key, dopt, seen):
    """The port's `draws` for one feed: the JAX feed's per-sample draws,
    re-derived from the key its feed_data splits off the trainer's
    local_key (`keys = split(key, 8)`; gaussian, poisson and JPEG quality
    of stage 1 from keys[0..2], of stage 2 from keys[3..5])."""
    keys = jax.random.split(jax.random.split(key)[1], 8)
    slot = {'gaussian': 0, 'poisson': 1, 'jpeg': 2}

    def draws(name, img, make):
        seen.append(name)
        kind, stage = name[:-1], int(name[-1])
        k, sfx = keys[slot[kind] + 3 * (stage - 1)], '' if stage == 1 else '2'
        x = img.numpy()
        if kind == 'gaussian':
            return jax_gaussian_draws(k, x, dopt['noise_range' + sfx])
        if kind == 'poisson':
            return jax_poisson_draws(k, x, dopt['poisson_scale_range' + sfx])
        lo, hi = dopt['jpeg_range' + sfx]
        return {'quality': _t(jax.random.uniform(k, (x.shape[0],),
                                                 jnp.float32, lo, hi))}
    return draws


def test_feed_and_step_hold_the_feed_limit(imnet, trainers, monkeypatch):
    """Two feeds (the first fills the queue, the second swaps; the noises
    poisson then gaussian, then gaussian twice) on the same batches,
    coins and draws; then the validation feed and the gt_usm switch; then
    one optimize_parameters on the port's fed batch."""
    jt, pt = trainers
    jit_the_jax_feed(monkeypatch)
    ds = PR.RealESRGANDataset(imnet, split='train', crop_size=CROP)
    seen = []
    for feed, seed in enumerate((0, 2)):
        random.seed(100 + feed), np.random.seed(100 + feed)
        batch = {k: np.stack([ds[i][k] for i in (feed % 4, (feed + 1) % 4)])
                 for k in ('gt', 'kernel1', 'kernel2', 'sinc_kernel')}
        key = jt.local_key
        random.seed(seed), np.random.seed(seed)
        jt.feed_data(batch)
        random.seed(seed), np.random.seed(seed)
        pt.feed_data(batch, draws=jax_feed_draws(key, pt.dopt, seen))
        assert pt.data['SR'].shape == pt.data['HR'].shape == (
            BATCH, GT_SIZE, GT_SIZE, 3)
        a = PR.feed_agreement(pt.data, jt.data)
        print('feed %d: %s' % (feed, a))
        assert a['ok'], a
    assert {n[:-1] for n in seen} == {'gaussian', 'poisson', 'jpeg'}, seen

    for usm in (True, False):
        jt.gt_usm_for_hr = pt.gt_usm_for_hr = usm
        jt.is_train = pt.is_train = False
        val = {'lq': batch['gt'][:, ::4, ::4], 'gt': batch['gt']}
        jt.feed_data(val)
        pt.feed_data(val)
        jt.is_train = pt.is_train = True
        np.testing.assert_allclose(pt.data['HR'].numpy(), jt.data['HR'],
                                   rtol=0, atol=2e-4)
        np.testing.assert_array_equal(pt.data['SR'].numpy(), jt.data['SR'])

    pt.feed_data(batch)        # the port's own draws from its generator
    assert torch.isfinite(pt.data['SR']).all()
    pt.optimize_parameters()
    assert np.isfinite(pt.log_dict['l_pix'])
