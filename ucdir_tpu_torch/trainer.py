"""The DDPM model wrapper. Counterpart of `ucdir_tpu/trainer.py` (reference:
model/model.py:35-268), with the reference's public surface: feed_data,
optimize_parameters, test, get_current_log, get_current_visuals,
set_new_noise_schedule, save_network and load_network."""
from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

from ucdir_tpu_torch.diffusion.sampler import unconditional_sample
from ucdir_tpu_torch.eval import eval_step
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.parallel.mesh import broadcast_
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.train import (create_train_state, make_optimizer,
                                   train_step)
from ucdir_tpu_torch.train.optim import finetune_select
from ucdir_tpu_torch.utils import checkpoint as ckpt_util
from ucdir_tpu_torch.utils.dist import get_dist_info

logger = logging.getLogger('base')

# diffusion buffers the reference registers on its module; recomputed here
SCHEDULE_BUFFERS = (
    'betas', 'alphas_cumprod', 'alphas_cumprod_prev', 'sqrt_alphas_cumprod',
    'sqrt_one_minus_alphas_cumprod', 'log_one_minus_alphas_cumprod',
    'sqrt_recip_alphas_cumprod', 'sqrt_recipm1_alphas_cumprod',
    'posterior_variance', 'posterior_log_variance_clipped',
    'posterior_mean_coef1', 'posterior_mean_coef2')


# opt['compute_dtype'] (sr.py's --compute_dtype) -> the networks' dtype in
# training and validation
COMPUTE_DTYPES = {None: None, 'bf16': torch.bfloat16}


def _unsupported(what: str):
    return NotImplementedError('%s is not ported yet; see ROADMAP.md' % what)


def _host(a):
    """A fed array or tensor as a host numpy array."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def local_seed(seed: int, rank: int) -> int:
    """The seed of a rank's own stream (the validation noise, the degraded
    inputs' noise, the Real-SR feed), the counterpart of the JAX package's
    `fold_in(PRNGKey(seed), process_index)`: `seed` itself on rank 0, so a
    one-process run draws what it drew before there were ranks."""
    return seed + rank * 0x9E3779B1


def ranks_share_images(opt, world_size: int) -> bool:
    """Whether the ranks restore each validation image together, its tiles
    split over them: under a process group of more than one rank with a
    `tile` dict in the config (the JAX package's mesh, which shards one
    image's tiles over its chips). Otherwise each rank restores its own
    share of the images."""
    return world_size > 1 and opt.get('tile') is not None


class Trainer:
    """phase 'train': optimizer steps on fed batches, validation with the
    live weights, checkpoints as the reference's triple. phase 'val':
    validation with the EMA (or live) weights of a checkpoint, or with the
    random weights the model is built with. Both in opt['compute_dtype']
    ('bf16': the networks in bfloat16 on a cast of the float32 weights,
    which with the optimizer state, the EMA shadow and the checkpoints stay
    float32; None: float32).

    Under a process group (`utils.dist.init_dist`) each rank holds one; the
    RNG contract is the JAX package's (`ucdir_tpu/trainer.py:45-55`): the
    training draws are the same on every rank (seeded from the seed and the
    step), the validation draws and the fed batches' noise are the rank's
    own (`local_seed`). The initial weights are rank 0's. With a `tile`
    dict in the config the ranks restore each validation image together
    (`shares_images`): its tiles split over them (tile_chunk the world size
    unless the dict sets it), its draws rank 0's on every rank, so each
    rank gets one process's bits."""

    def __init__(self, opt, device, seed: int = 0):
        name = opt.get('compute_dtype')
        if name not in COMPUTE_DTYPES:
            raise ValueError('compute_dtype %r: expected bf16 or None'
                             % (name,))
        self.compute_dtype = COMPUTE_DTYPES[name]
        self.opt = opt
        self.device = torch.device(device)
        self.seed = seed
        self.rank, self.world_size = get_dist_info()
        self.shares_images = ranks_share_images(opt, self.world_size)
        self.model = define_G(opt).to(self.device)
        self.schedules = {}
        self.schedule_phase = None
        self.set_new_noise_schedule(
            opt['model']['beta_schedule'][opt['phase']], opt['phase'])
        # validation noise, the rank's own (rank 0's where the ranks share
        # each image); the training draws are seeded per step instead
        # (optimize_parameters), so a resumed run repeats them
        self.generator = torch.Generator(self.device).manual_seed(
            local_seed(seed + 1, 0 if self.shares_images else self.rank))
        self.train_generator = torch.Generator(self.device)
        self.iter = 0
        self.begin_step = 0
        self.begin_epoch = 0
        self.log_dict = OrderedDict()
        self.data: Dict[str, Any] = {}
        if opt['phase'] == 'train':
            self.model.train()
            # every rank starts from rank 0's weights (a resume then loads
            # the same triple on every rank)
            broadcast_(self.model.state_dict().values())
            params = self.model.parameters()
            ft = opt['model'].get('finetune_norm')
            if ft:
                params = finetune_select(
                    self.model, ft if isinstance(ft, str) else 'transformer')
                logger.info('finetune_norm: optimizing %d param tensors '
                            '(zero-initialized), rest frozen', len(params))
            self.state = create_train_state(
                self.model, make_optimizer(params, opt['train']['optimizer']),
                opt['train']['ema_scheduler'], clip_norm=opt.get('clip_norm'))
        else:
            self.model.eval()
            self.state = None
        self.load_network()
        n = sum(p.numel() for p in self.model.parameters())
        logger.info('Network G created, with parameters: {:,d}'.format(n))

    def feed_data(self, data: Dict[str, Any]):
        self.data = {k: np.asarray(v) if not np.isscalar(v) else v
                     for k, v in data.items()}

    def to_device(self, a):
        """A host array as a float32 tensor on the trainer's device; to the
        card through pinned memory, without waiting for the copy. A tensor
        on the trainer's device passes through as it is."""
        if torch.is_tensor(a):
            return a.to(self.device, torch.float32)
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        if self.device.type == 'cuda':
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def optimize_parameters(self, draws=None):
        """One optimizer step on the fed batch (reference model.py:104-122),
        the networks in opt['compute_dtype']; under a process group the fed
        batch is this rank's rows of the global batch, and the logged l_pix
        the global batch's loss. draws: injected 'gammas' and 'noise' of the
        global batch (`train_step`'s), on the trainer's device."""
        batch = {k: self.to_device(self.data[k]) for k in ('HR', 'SR')}
        loss = train_step(self.state, self.schedules['train'], batch,
                          generator=self.step_generator(self.iter),
                          draws=draws, compute_dtype=self.compute_dtype,
                          rank=self.rank, world_size=self.world_size)
        self.log_dict['l_pix'] = float(loss)
        self.iter += 1

    def step_generator(self, step: int):
        """The generator of step `step`'s draws (noise level, noise, dropout
        mask), seeded from the trainer's seed and the step alone."""
        return self.train_generator.manual_seed(self.seed * 1_000_003 + step)

    def get_current_log(self):
        return self.log_dict

    def set_new_noise_schedule(self, schedule_opt, schedule_phase='train',
                               force: bool = False):
        if self.schedule_phase != schedule_phase or force:
            self.schedule_phase = schedule_phase
            self.schedules[schedule_phase] = make_schedule(schedule_opt,
                                                           self.device)

    def test(self, continous: bool = False, noise=None):
        """Restores self.data['SR'] under the current schedule with noise from
        this trainer's generator (or `noise(shape)`, injected); in the train
        phase with the live weights. opt['sampler'],
        opt['sampling_timesteps'] (default 20 for dpmpp, else 5) and
        opt['tile'] choose the sampler and the tiled path (over the ranks
        where `shares_images`), and opt['compute_dtype'] the networks'
        dtype."""
        sr = self.to_device(self.data['SR'])
        sampler = self.opt.get('sampler') or 'ddpm'
        tile = self.opt.get('tile')
        if self.shares_images:
            # the ranks restore rank 0's input together (a feed that adds
            # the rank's own noise, DDPM_bnoise's, would differ)
            broadcast_([sr])
            tile = {'tile_chunk': self.world_size, **tile,
                    'distributed': True}
        steps = int(self.opt.get('sampling_timesteps')
                    or (20 if sampler == 'dpmpp' else 5))
        was_training = self.model.training
        self.model.eval()
        try:
            out = eval_step(self.model, self.schedules[self.schedule_phase],
                            sr, continous=continous, noise=noise,
                            generator=self.generator,
                            sampler=sampler, sampling_timesteps=steps,
                            tile=tile, compute_dtype=self.compute_dtype)
        finally:
            self.model.train(was_training)
        if continous:
            _, initx, snaps = out
            snaps = snaps.cpu().numpy()
            # (frames, h, w, c) at batch 1, as the reference returns it
            self.SR = snaps[:, 0] if sr.shape[0] == 1 else snaps
        else:
            final, initx = out
            self.SR = final.cpu().numpy()
        # None for a variant with no predictor
        self.pre_initx = None if initx is None else initx.cpu().numpy()

    def sample(self, batch_size: int = 1, continous: bool = False,
               noise=None):
        """Unconditional generation (reference DDPM.sample, model.py:
        140-147) of `batch_size` images of the config's diffusion
        image_size and channels, under the current schedule with the
        weights test() uses and noise from this trainer's generator (or
        `noise(shape)`, injected). Sets and returns self.SR: the images
        (B, H, W, C), or with continous the snapshots (frames, B, H, W,
        C)."""
        diff = self.opt['model']['diffusion']
        size = int(diff.get('image_size', 128))
        shape = (batch_size, size, size, int(diff.get('channels', 3)))
        was_training = self.model.training
        self.model.eval()
        try:
            out = unconditional_sample(
                self.model, self.schedules[self.schedule_phase], shape,
                noise=noise, generator=self.generator, continous=continous,
                compute_dtype=self.compute_dtype)
        finally:
            self.model.train(was_training)
        self.SR = (out[1] if continous else out).cpu().numpy()
        return self.SR

    def get_current_visuals(self, sample: bool = False):
        out = OrderedDict()
        if sample:
            out['SAM'] = self.SR
            return out
        out['SR'] = self.SR
        out['INF'] = _host(self.data['SR'])
        out['HR'] = _host(self.data['HR'])
        out['LR'] = _host(self.data.get('LR', out['INF']))
        return out

    def save_network(self, epoch, iter_step):
        """Writes I{iter}_E{epoch}_{gen,gen_ema,opt}.pth under
        opt['path']['checkpoint']."""
        prefix = ckpt_util.save_state(self.opt['path']['checkpoint'], epoch,
                                      iter_step, self.state)
        logger.info('Saved model in [{:s}] ...'.format(prefix))
        return prefix

    def load_network(self):
        """From opt['path']['resume_state']. Train phase: the triple at the
        prefix restores weights, EMA shadow, optimizer, step and epoch. Val
        phase: `<prefix>_gen_ema.pth` (or `_gen.pth` without EMA, or a direct
        .pth path), with strict=True."""
        prefix = self.opt['path'].get('resume_state')
        if not prefix:
            return
        if self.opt['phase'] == 'train':
            logger.info('Loading pretrained model for G [{:s}] ...'
                        .format(prefix))
            self.iter, self.begin_epoch = ckpt_util.restore_state(
                prefix, self.state)
            self.begin_step = self.iter
            return
        use_ema = bool(((self.opt.get('train') or {}).get('ema_scheduler')
                        or {}).get('use', True))
        path = prefix if prefix.endswith('.pth') else prefix + (
            '_gen_ema.pth' if use_ema else '_gen.pth')
        if not os.path.isfile(path):
            raise FileNotFoundError('checkpoint not found: %s' % path)
        logger.info('Loading pretrained model for G [{:s}] ...'.format(path))
        sd = torch.load(path, map_location='cpu', weights_only=True)
        sd = {k: v for k, v in sd.items() if k not in SCHEDULE_BUFFERS}
        self.model.load_state_dict(sd, strict=True)


class TrainerBNoise(Trainer):
    """DDPM_bnoise: adds sigma = 50/255 Gaussian noise, twice over, to the
    degraded input of every fed batch (reference model.py:270-280; the JAX
    package's `TrainerBNoise`). The draws come from a generator of the
    trainer's own, seeded from its seed and its rank, on the host where the
    batch is."""

    def __init__(self, opt, device, seed: int = 0):
        super().__init__(opt, device, seed)
        self.noise_generator = torch.Generator().manual_seed(
            local_seed(seed + 2, self.rank))

    def draw_noise(self, shape):
        """Standard normal draws of `shape` (float32 numpy) from the
        trainer's noise generator."""
        return torch.randn(tuple(shape), generator=self.noise_generator,
                           dtype=torch.float32).numpy()

    def feed_data(self, data):
        super().feed_data(data)
        sr = np.asarray(self.data['SR'], np.float32)
        self.data['SR'] = sr + self.draw_noise(sr.shape) * 2 * (50. / 255.)


MODELS = {'DDPM': Trainer, 'DDPM_bnoise': TrainerBNoise}


def create_model(opt, **kwargs):
    """The trainer that opt['model']['name'] names (reference
    model/__init__.py:5-10; the JAX package's `create_model`): DDPM (the
    default) builds `Trainer`, DDPM_bnoise `TrainerBNoise`, DDPM_realsr
    `realsr.TrainerRealSR`. Any other name raises NotImplementedError."""
    name = (opt.get('model') or {}).get('name', 'DDPM') or 'DDPM'
    if name == 'DDPM_realsr':
        from ucdir_tpu_torch.realsr import TrainerRealSR
        return TrainerRealSR(opt, **kwargs)
    if name not in MODELS:
        raise _unsupported('model.name %r' % (name,))
    return MODELS[name](opt, **kwargs)
