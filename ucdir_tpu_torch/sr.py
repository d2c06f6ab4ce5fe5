"""Train and validation entry point of the port, with the CLI names, cadences
and result files of the repo's `sr.py`:

    python -m ucdir_tpu_torch.sr -p train -c ucdir_tpu/configs/sid.yaml \\
        [--seed N] [--device cuda] [-debug] [--compute_dtype bf16]
    python -m ucdir_tpu_torch.sr -p val -c ucdir_tpu/configs/sid.yaml \\
        [--checkpoint <prefix>] [--seed N] [--device cuda] [--val_batch N] \\
        [--sampler ddpm|ddim|dpmpp|dpmpp_sde] [--sampling_timesteps N] \\
        [--val_patch [--patch_skip 1024] [--patch_padding 64]] \\
        [--search_params [--search_steps 25,50,100] \\
                         [--search_ends 0.2,0.4,0.6]] [--compute_dtype bf16]
    torchrun --nproc_per_node N -m ucdir_tpu_torch.sr -p train|val \\
        --distributed ...
    [-enable_wandb [-log_wandb_ckpt] [-log_eval]]

Training saves the reference's checkpoint triple
`I{iter}_E{epoch}_{gen,gen_ema,opt}.pth` and resumes from the prefix in the
config's `path.resume_state`; `-p val --checkpoint <prefix>` validates a
triple's EMA weights. Without a checkpoint the model starts from the random
weights of --seed. One process on one card, or with --distributed one
process per card, joined by torch.distributed (NCCL; gloo with --device
cpu): the global batch of the config is split over the ranks, the gradients
are averaged over them every step, each rank validates its shard of the
validation set and the logged means are the whole set's; rank 0 saves. A
validation batch (--val_batch) holds images of one size, each scored and
saved under its own name. Float32, or `--compute_dtype bf16`:
validation runs the networks in bfloat16 on a copy of the weights and the
sampler in float32, training runs them on a bfloat16 cast of the float32
weights, which with the optimizer state, the EMA and the checkpoints stay
float32. Validation inputs
above 4.3 M px after the 64-px pad are restored tiled (1024-px tiles, 64-px
halos) inside every denoising step (DDPM keeps its state tiled across the
steps, parallel/resident.py); `--val_patch` instead runs a whole reverse
process per tile, and `--search_params` sweeps the validation schedule. With
a `tile` dict in the config ({skip, padding, tile_chunk}) every input above
skip x skip is tiled, and under --distributed the ranks then restore each
validation image together, its tiles split over them, every rank walking
the whole set and rank 0 saving. TensorBoard scalars and images go to the
config's `path.tb_logger` where tensorboardX imports; `-enable_wandb` logs
to W&B where `wandb` imports (else a warning), `-log_wandb_ckpt` uploads
the latest checkpoints and `-log_eval` the validation table.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ucdir_tpu_torch.parallel.mesh import barrier, global_sums


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('-c', '--config', type=str,
                   default='ucdir_tpu/configs/sid.yaml')
    p.add_argument('-p', '--phase', type=str, choices=['train', 'val'],
                   default='val')
    p.add_argument('-debug', '-d', action='store_true', dest='debug')
    p.add_argument('-enable_wandb', action='store_true',
                   help='log to W&B (needs the wandb package)')
    p.add_argument('-log_wandb_ckpt', action='store_true',
                   help='with -enable_wandb: upload the latest checkpoints')
    p.add_argument('-log_eval', action='store_true',
                   help='with -enable_wandb: log the validation table')
    p.add_argument('--checkpoint', type=str, default=None,
                   help='validation checkpoint prefix (loads '
                        '<prefix>_gen_ema.pth) or a .pth path')
    p.add_argument('--sampler', type=str, default='ddpm',
                   choices=['ddpm', 'ddim', 'dpmpp', 'dpmpp_sde'])
    p.add_argument('--sampling_timesteps', type=int, default=None,
                   help='steps for ddim, dpmpp_sde (default 5) and dpmpp '
                        '(default 20)')
    p.add_argument('--compute_dtype', type=str, default=None,
                   choices=['bf16'])
    p.add_argument('--val_batch', type=int, default=1,
                   help='validation images per step (-p val; they must '
                        'share one size)')
    p.add_argument('--val_patch', action='store_true',
                   help='a whole reverse process per tile, then reassemble')
    p.add_argument('--patch_skip', type=int, default=1024,
                   help='val_patch tile size')
    p.add_argument('--patch_padding', type=int, default=64,
                   help='val_patch tile halo')
    p.add_argument('--search_params', action='store_true',
                   help='grid search over the validation schedule')
    p.add_argument('--search_steps', type=str, default='25,50,100',
                   help='search_params n_timestep grid (comma list)')
    p.add_argument('--search_ends', type=str, default='0.2,0.4,0.6',
                   help='search_params linear_end grid (comma list)')
    p.add_argument('--seed', type=int, default=0,
                   help='seed of the random weights, of the training draws '
                        'and of the sampling noise')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default) or 'cpu' (the kernels' plain "
                        "versions)")
    p.add_argument('--distributed', action='store_true',
                   help='one rank of a data-parallel run: joins the process '
                        'group of torchrun (or of srun without torchrun), '
                        'NCCL on cuda, gloo on cpu')
    return p


def _global_mean(*sums_and_count):
    """The mean over every rank: [sum..., count] summed over the ranks in
    float64, the sums divided by the count (JAX sr.py's `_global_mean`). The
    reference logs each rank's shard mean only; this is the whole set's."""
    vec = global_sums(sums_and_count)
    count = max(vec[-1], 1.0)
    return tuple(v / count for v in vec[:-1])


def _val_mean(diffusion, *sums_and_count):
    """The validation mean: every rank's images' (`_global_mean`), or,
    where the ranks restore the same images together, this rank's, taken
    once."""
    if diffusion.shares_images:
        count = max(sums_and_count[-1], 1)
        return tuple(v / count for v in sums_and_count[:-1])
    return _global_mean(*sums_and_count)


class _Logs:
    """The run's TensorBoard writer and W&B logger, each None where it is
    off or its package is absent; on rank 0 only."""

    def __init__(self, opt, rank, logger):
        self.tb = self.wandb = None
        self.val_step = 0
        if rank != 0:
            return
        tb_dir = opt['path'].get('tb_logger')
        if tb_dir:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(log_dir=tb_dir)
            except ImportError:
                self.tb = None
        if opt['enable_wandb']:
            try:
                import wandb

                from ucdir_tpu_torch.utils.wandb_logger import WandbLogger
                self.wandb = WandbLogger(opt)
                # validation metrics on their own step axis (reference
                # sr.py:363-370)
                wandb.define_metric('validation/val_step')
                wandb.define_metric('epoch')
                wandb.define_metric('validation/*', step_metric='val_step')
            except ImportError as e:
                logger.warning('wandb unavailable: %s', e)

    def scalars(self, logs, step):
        if self.tb is not None:
            for k, v in logs.items():
                self.tb.add_scalar(k, v, step)
        if self.wandb is not None:
            self.wandb.log_metrics(dict(logs))

    def val_image(self, tag, idx, fake_img, sr_img, hr_img):
        """(predictor | restored | target) side by side."""
        row = np.concatenate((fake_img, sr_img, hr_img), axis=1)
        if self.tb is not None:
            self.tb.add_image(tag, np.transpose(row, [2, 0, 1]), idx)
        if self.wandb is not None:
            self.wandb.log_image('validation_{}'.format(idx), row)

    def val_psnr(self, psnr, step):
        if self.tb is not None:
            self.tb.add_scalar('psnr', psnr, step)
        if self.wandb is not None:
            self.wandb.log_metrics({'validation/val_psnr': psnr,
                                    'validation/val_step': self.val_step})
            self.val_step += 1

    def close(self):
        if self.tb is not None:
            self.tb.close()


def val_patch(opt, val_loader, val_set, diffusion, Metrics, logger,
              skip: int = 1024, padding: int = 64):
    """Outer-loop tiled sampling: each tile runs its own full reverse process
    (the reference's alternative loop `val_patch`, sr.py:17-57), unlike the
    tiling inside every step of ucdir_tpu_torch.parallel.tiled. As in the
    JAX package: a batch of --val_batch images is restored as one, scored
    and saved as one grid image under the name of its first image, and
    each rank logs its own shard's mean."""
    from ucdir_tpu_torch.parallel.tiled import _grid_pad, compute_tile_starts
    result_path = opt['path']['results']
    os.makedirs(result_path, exist_ok=True)
    avg_psnr, idx = 0.0, 0
    for val_data in val_loader:
        idx += 1
        sr = np.asarray(val_data['SR'])
        pd = _grid_pad(sr.shape[1], sr.shape[2], skip, padding)
        sr_pad = np.pad(sr, ((0, 0), (pd, pd), (pd, pd), (0, 0)), 'reflect')
        H, W = sr_pad.shape[1:3]
        out = np.zeros_like(sr_pad[..., :3])
        for hs, ws in compute_tile_starts(H, W, skip, padding):
            tile = sr_pad[:, hs:hs + skip, ws:ws + skip]
            diffusion.feed_data({'SR': tile, 'HR': tile})
            diffusion.test(continous=False)
            out[:, hs + padding:hs + skip - padding,
                ws + padding:ws + skip - padding] = \
                diffusion.SR[:, padding:-padding, padding:-padding]
        out = out[:, pd:-pd, pd:-pd]
        sr_img = Metrics.tensor2img(out)
        hr_img = Metrics.tensor2img(np.asarray(val_data['HR']))
        fname = ''.join(os.path.basename(
            val_set.sr_path[int(val_data['Index'][0])]).split('.')[:-1])
        base = '{}/{}_{}'.format(result_path, fname, opt['name'])
        if _saves(diffusion):
            Metrics.save_jpg(sr_img, base + '_sr.png')
            Metrics.save_jpg(hr_img, base + '_hr.png')
        avg_psnr += Metrics.calculate_psnr(sr_img, hr_img)
    avg_psnr /= max(idx, 1)
    logger.info('# val_patch # PSNR: {:.4e}'.format(avg_psnr))
    return avg_psnr


def search_params(opt, val_loader, diffusion, Metrics, logger,
                  n_timesteps=(25, 50, 100), linear_ends=(0.2, 0.4, 0.6)):
    """Grid search over the validation schedule's length and linear_end on
    the first 3 images, with every cell's images saved (the reference's
    alternative loop `search_params`, sr.py:60-126). Returns {(steps,
    linear_end): mean PSNR}. As in the JAX package: with --val_batch the
    first 3 batches, each scored and saved as one grid image, and each rank
    searches on its own shard."""
    result_path = opt['path']['results']
    os.makedirs(result_path, exist_ok=True)
    found = {}
    for nt in n_timesteps:
        for le in linear_ends:
            sched_opt = dict(opt['model']['beta_schedule']['val'],
                             n_timestep=nt, linear_end=le)
            diffusion.set_new_noise_schedule(sched_opt, 'val', force=True)
            psnr, idx = 0.0, 0
            for val_data in val_loader:
                idx += 1
                diffusion.feed_data(val_data)
                diffusion.test(continous=False)
                visuals = diffusion.get_current_visuals()
                sr_img = Metrics.tensor2img(visuals['SR'])
                hr_img = Metrics.tensor2img(visuals['HR'])
                psnr += Metrics.calculate_psnr(sr_img, hr_img)
                if _saves(diffusion):
                    Metrics.save_jpg(sr_img, '{}/s{}_e{}_{}_sr.png'.format(
                        result_path, nt, le, idx))
                if idx >= 3:
                    break
            found[(nt, le)] = psnr / max(idx, 1)
            logger.info('# search steps=%d linear_end=%.2f PSNR: %.4f'
                        % (nt, le, found[(nt, le)]))
    return found


def _saves(diffusion) -> bool:
    """Whether this rank writes the validation images: each rank its own
    share's, or rank 0 alone where the ranks restore the same images (a
    trainer without `shares_images` restores its own)."""
    return not getattr(diffusion, 'shares_images', False) or \
        diffusion.rank == 0


def _train(opt, diffusion, train_loader, val_loader, Metrics, logger,
           logs):
    """The training loop of the repo's sr.py: print every print_freq steps,
    validate with the live weights every val_freq steps and at step 50, save
    at save_models and save_checkpoint_freq; `logs` at the JAX CLI's points.
    Under a process group each rank validates its shard (or, sharing each
    image, the whole set, rank 0 saving), the logged PSNR is the whole
    set's, the images are named after `current_step + rank` (the JAX
    package's naming, kept), and rank 0 saves while the others wait."""
    rank = diffusion.rank
    current_step = diffusion.begin_step
    current_epoch = diffusion.begin_epoch
    n_iter = opt['train']['n_iter']
    if opt['path']['resume_state']:
        logger.info('Resuming training from epoch: {}, iter: {}.'.format(
            current_epoch, current_step))
    schedules = opt['model']['beta_schedule']
    while current_step < n_iter:
        current_epoch += 1
        train_loader.set_epoch(current_epoch)
        for train_data in train_loader:
            current_step += 1
            if current_step > n_iter:
                break
            diffusion.feed_data(train_data)
            diffusion.optimize_parameters()

            if current_step % opt['train']['print_freq'] == 0:
                message = '<epoch:{:3d}, iter:{:8,d}> {:s}'.format(
                    current_epoch, current_step, opt['name'])
                for k, v in diffusion.get_current_log().items():
                    message += '{:s}: {:.4e} '.format(k, v)
                logger.info(message)
                logs.scalars(diffusion.get_current_log(), current_step)

            if (current_step % opt['train']['val_freq'] == 0
                    or current_step == 50):
                avg_psnr = 0.0
                idx = 0
                result_path = '{}/{}'.format(opt['path']['results'],
                                             current_epoch)
                os.makedirs(result_path, exist_ok=True)
                diffusion.set_new_noise_schedule(schedules['val'],
                                                 schedule_phase='val')
                for val_data in val_loader:
                    idx += 1
                    diffusion.feed_data(val_data)
                    diffusion.test(continous=False)
                    visuals = diffusion.get_current_visuals()
                    sr_img = Metrics.tensor2img(visuals['SR'])
                    hr_img = Metrics.tensor2img(visuals['HR'])
                    fake_img = Metrics.tensor2img(visuals['INF'])
                    base = '{}/{}_{}_{}'.format(
                        result_path, current_step + rank, idx, opt['name'])
                    if _saves(diffusion):
                        Metrics.save_img(hr_img, base + '_hr.png')
                        Metrics.save_img(sr_img, base + '_sr.png')
                        Metrics.save_img(Metrics.tensor2img(visuals['LR']),
                                         base + '_lr.png')
                        Metrics.save_img(fake_img, base + '_inf.png')
                    logs.val_image('Iter_{}'.format(current_step + rank),
                                   idx, fake_img, sr_img, hr_img)
                    avg_psnr += Metrics.calculate_psnr(sr_img, hr_img)
                (avg_psnr,) = _val_mean(diffusion, avg_psnr, idx)
                diffusion.set_new_noise_schedule(schedules['train'],
                                                 schedule_phase='train')
                logger.info('# Validation # PSNR: {:.4e}'.format(avg_psnr))
                logging.getLogger('val').info(
                    '<epoch:{:3d}, iter:{:8,d}> psnr: {:.4e}'.format(
                        current_epoch, current_step, avg_psnr))
                logs.val_psnr(avg_psnr, current_step)

            # rank 0 saves; no rank goes on past a half-written triple
            if current_step % opt['train']['save_models'] == 0:
                if rank == 0:
                    diffusion.save_network(current_epoch, current_step)
                barrier()
            if current_step % opt['train']['save_checkpoint_freq'] == 0:
                if rank == 0:
                    logger.info('Saving models and training states.')
                    diffusion.save_network('latest', '')
                    if logs.wandb is not None and opt['log_wandb_ckpt']:
                        logs.wandb.log_checkpoint(current_epoch,
                                                  current_step)
                barrier()
        if logs.wandb is not None:
            logs.wandb.log_metrics({'epoch': current_epoch - 1})
    logger.info('End of training.')


def _validate(opt, diffusion, val_loader, val_set, Metrics, logger, logs):
    """Restores every image of the rank's shard (or, sharing each image,
    of the whole set), batch by batch, saves each image's results under its
    own name and logs the mean PSNR and SSIM over every rank's images (JAX
    sr.py:390-430), to W&B too where `logs` has it."""
    logger.info('Begin Model Evaluation. len ' + str(len(val_loader)))
    avg_psnr = avg_ssim = 0.0
    idx = 0
    result_path = opt['path']['results']
    os.makedirs(result_path, exist_ok=True)
    for i, val_data in enumerate(val_loader):
        logger.info('val index %d' % i)
        diffusion.feed_data(val_data)
        diffusion.test(continous=True)
        visuals = diffusion.get_current_visuals()
        batch = visuals['HR'].shape[0]
        # SR snapshots: (F, h, w, c) at batch 1, (F, b, h, w, c) above
        sr_last = visuals['SR'][-1]
        for j in range(batch):
            idx += 1
            fname = ''.join(os.path.basename(
                val_set.sr_path[int(val_data['Index'][j])]).split('.')[:-1])
            hr_img = Metrics.tensor2img(visuals['HR'][j])
            lr_img = Metrics.tensor2img(visuals['LR'][j])
            # the predictor's estimate, or the degraded input where the
            # variant has no predictor (JAX sr.py:403-406)
            fake_img = Metrics.tensor2img(
                visuals['INF'][j] if diffusion.pre_initx is None
                else diffusion.pre_initx[j])
            sr_final = Metrics.tensor2img(sr_last[j] if batch > 1
                                          else sr_last)
            base = '{}/{}_{}'.format(result_path, fname, opt['name'])
            if _saves(diffusion):
                Metrics.save_jpg(sr_final, base + '_sr.png')
                Metrics.save_jpg(hr_img, base + '_hr.png')
                Metrics.save_jpg(lr_img, base + '_lr.png')
                Metrics.save_jpg(fake_img, base + '_inf.png')
            psnr = Metrics.calculate_psnr(sr_final, hr_img)
            ssim = Metrics.calculate_ssim(sr_final, hr_img)
            avg_psnr += psnr
            avg_ssim += ssim
            if logs.wandb is not None and opt['log_eval']:
                logs.wandb.log_eval_data(fake_img, sr_final, hr_img, psnr,
                                         ssim)

    avg_psnr, avg_ssim = _val_mean(diffusion, avg_psnr, avg_ssim, idx)
    logger.info('# Validation # PSNR: {:.4e}'.format(avg_psnr))
    logger.info('# Validation # SSIM: {:.4e}'.format(avg_ssim))
    logging.getLogger('val').info(
        '<epoch:{:3d}, iter:{:8,d}> psnr: {:.4e}, ssim: {:.4e}'.format(
            0, 0, avg_psnr, avg_ssim))
    if logs.wandb is not None:
        if opt['log_eval']:
            logs.wandb.log_eval_table()
        logs.wandb.log_metrics({'PSNR': float(avg_psnr),
                                'SSIM': float(avg_ssim)})
    return avg_psnr, avg_ssim


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    from ucdir_tpu_torch.utils.dist import exit_dist, init_dist

    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('--device %s, but CUDA is not available; pass '
                           '--device cpu to run the plain versions'
                           % args.device)
    if not args.distributed:
        return _run(args, args.device)
    # torchrun sets RANK; srun alone sets SLURM_PROCID
    launcher = ('slurm' if 'SLURM_PROCID' in os.environ
                and 'RANK' not in os.environ else 'pytorch')
    device = init_dist(launcher, device=args.device.split(':')[0])
    try:
        return _run(args, str(device))
    finally:
        exit_dist()


def _run(args, device):
    import torch

    from ucdir_tpu_torch import config as Logger
    from ucdir_tpu_torch import data as Data
    from ucdir_tpu_torch.metrics import core as Metrics
    from ucdir_tpu_torch.trainer import create_model, ranks_share_images
    from ucdir_tpu_torch.utils.dist import get_dist_info
    from ucdir_tpu_torch.utils.logging import setup_logger

    # full float32 in cuDNN's convolutions and in matmuls (no TF32), so the
    # card computes what the CPU and the JAX reference compute
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(args.seed)
    rank, world_size = get_dist_info()

    opt = Logger.parse(args.config, phase=args.phase,
                       checkpoint=args.checkpoint, debug=args.debug,
                       enable_wandb=args.enable_wandb,
                       num_processes=world_size)
    opt['log_wandb_ckpt'] = args.log_wandb_ckpt
    opt['log_eval'] = args.log_eval
    opt['sampler'] = args.sampler
    opt['sampling_timesteps'] = args.sampling_timesteps
    opt['compute_dtype'] = args.compute_dtype
    setup_logger('base', opt['path']['log'], 'train', level=logging.INFO,
                 screen=True, process_index=rank)
    setup_logger('val', opt['path']['log'], 'val', level=logging.INFO,
                 process_index=rank)
    logger = logging.getLogger('base')
    logger.info(Logger.dict2str(opt))
    logs = _Logs(opt, rank, logger)

    train_loader = None
    if args.phase == 'train':
        train_opt = opt['datasets']['train']
        train_set = Data.create_dataset(train_opt, 'train')
        train_loader = Data.create_dataloader(
            train_set, train_opt, 'train', rank=rank, world_size=world_size,
            seed=args.seed)
    val_opt = opt['datasets']['val']
    if args.phase == 'val':
        val_opt['val_batch'] = args.val_batch
    val_set = Data.create_dataset(val_opt, 'val')
    # ranks that restore each image together all walk the whole set
    shares = ranks_share_images(opt, world_size)
    val_loader = Data.create_dataloader(
        val_set, val_opt, 'val', rank=0 if shares else rank,
        world_size=1 if shares else world_size)
    logger.info('Initial Dataset Finished')
    diffusion = create_model(opt, device=device, seed=args.seed)
    logger.info('Initial Model Finished')

    try:
        if args.phase == 'train':
            return _train(opt, diffusion, train_loader, val_loader, Metrics,
                          logger, logs)
        if args.search_params:
            logger.info('Begin Model Evaluation. len '
                        + str(len(val_loader)))
            return search_params(
                opt, val_loader, diffusion, Metrics, logger,
                n_timesteps=tuple(int(s)
                                  for s in args.search_steps.split(',')),
                linear_ends=tuple(float(s)
                                  for s in args.search_ends.split(',')))
        if args.val_patch:
            logger.info('Begin Model Evaluation. len '
                        + str(len(val_loader)))
            return val_patch(opt, val_loader, val_set, diffusion, Metrics,
                             logger, skip=args.patch_skip,
                             padding=args.patch_padding)
        return _validate(opt, diffusion, val_loader, val_set, Metrics,
                         logger, logs)
    finally:
        logs.close()


if __name__ == '__main__':
    main()
