"""Train and validation entry point of the port, with the CLI names, cadences
and result files of the repo's `sr.py`:

    python -m ucdir_tpu_torch.sr -p train -c ucdir_tpu/configs/sid.yaml \\
        [--seed N] [--device cuda] [-debug] [--compute_dtype bf16]
    python -m ucdir_tpu_torch.sr -p val -c ucdir_tpu/configs/sid.yaml \\
        [--checkpoint <prefix>] [--seed N] [--device cuda] \\
        [--sampler ddpm|ddim|dpmpp|dpmpp_sde] [--sampling_timesteps N] \\
        [--val_patch [--patch_skip 1024] [--patch_padding 64]] \\
        [--search_params [--search_steps 25,50,100] \\
                         [--search_ends 0.2,0.4,0.6]] [--compute_dtype bf16]

Training saves the reference's checkpoint triple
`I{iter}_E{epoch}_{gen,gen_ema,opt}.pth` and resumes from the prefix in the
config's `path.resume_state`; `-p val --checkpoint <prefix>` validates a
triple's EMA weights. Without a checkpoint the model starts from the random
weights of --seed. One process, one card; float32, or `--compute_dtype bf16`:
validation runs the networks in bfloat16 on a copy of the weights and the
sampler in float32, training runs them on a bfloat16 cast of the float32
weights, which with the optimizer state, the EMA and the checkpoints stay
float32. Validation inputs
above 4.3 M px after the 64-px pad are restored tiled (1024-px tiles, 64-px
halos) inside every denoising step; `--val_patch` instead runs a whole
reverse process per tile, and `--search_params` sweeps the validation
schedule.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('-c', '--config', type=str,
                   default='ucdir_tpu/configs/sid.yaml')
    p.add_argument('-p', '--phase', type=str, choices=['train', 'val'],
                   default='val')
    p.add_argument('-debug', '-d', action='store_true', dest='debug')
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
    p.add_argument('--val_batch', type=int, default=1)
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
    return p


def _refuse(args):
    """NotImplementedError for every option the port does not carry yet."""
    todo = [(args.val_batch > 1, '--val_batch > 1')]
    for hit, what in todo:
        if hit:
            raise NotImplementedError('%s is not ported yet; see ROADMAP.md'
                                      % what)


def val_patch(opt, val_loader, val_set, diffusion, Metrics, logger,
              skip: int = 1024, padding: int = 64):
    """Outer-loop tiled sampling: each tile runs its own full reverse process
    (the reference's alternative loop `val_patch`, sr.py:17-57), unlike the
    tiling inside every step of ucdir_tpu_torch.parallel.tiled."""
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
    linear_end): mean PSNR}."""
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
                Metrics.save_jpg(sr_img, '{}/s{}_e{}_{}_sr.png'.format(
                    result_path, nt, le, idx))
                if idx >= 3:
                    break
            found[(nt, le)] = psnr / max(idx, 1)
            logger.info('# search steps=%d linear_end=%.2f PSNR: %.4f'
                        % (nt, le, found[(nt, le)]))
    return found


def _train(opt, diffusion, train_loader, val_loader, Metrics, logger):
    """The training loop of the repo's sr.py: print every print_freq steps,
    validate with the live weights every val_freq steps and at step 50, save
    at save_models and save_checkpoint_freq."""
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
                    base = '{}/{}_{}_{}'.format(result_path, current_step,
                                                idx, opt['name'])
                    Metrics.save_img(hr_img, base + '_hr.png')
                    Metrics.save_img(sr_img, base + '_sr.png')
                    Metrics.save_img(Metrics.tensor2img(visuals['LR']),
                                     base + '_lr.png')
                    Metrics.save_img(Metrics.tensor2img(visuals['INF']),
                                     base + '_inf.png')
                    avg_psnr += Metrics.calculate_psnr(sr_img, hr_img)
                avg_psnr /= max(idx, 1)
                diffusion.set_new_noise_schedule(schedules['train'],
                                                 schedule_phase='train')
                logger.info('# Validation # PSNR: {:.4e}'.format(avg_psnr))
                logging.getLogger('val').info(
                    '<epoch:{:3d}, iter:{:8,d}> psnr: {:.4e}'.format(
                        current_epoch, current_step, avg_psnr))

            if current_step % opt['train']['save_models'] == 0:
                diffusion.save_network(current_epoch, current_step)
            if current_step % opt['train']['save_checkpoint_freq'] == 0:
                logger.info('Saving models and training states.')
                diffusion.save_network('latest', '')
    logger.info('End of training.')


def _validate(opt, diffusion, val_loader, val_set, Metrics, logger):
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
        idx += 1
        fname = ''.join(os.path.basename(
            val_set.sr_path[int(val_data['Index'][0])]).split('.')[:-1])
        hr_img = Metrics.tensor2img(visuals['HR'][0])
        lr_img = Metrics.tensor2img(visuals['LR'][0])
        fake_img = Metrics.tensor2img(diffusion.pre_initx[0])
        sr_final = Metrics.tensor2img(visuals['SR'][-1])
        base = '{}/{}_{}'.format(result_path, fname, opt['name'])
        Metrics.save_jpg(sr_final, base + '_sr.png')
        Metrics.save_jpg(hr_img, base + '_hr.png')
        Metrics.save_jpg(lr_img, base + '_lr.png')
        Metrics.save_jpg(fake_img, base + '_inf.png')
        avg_psnr += Metrics.calculate_psnr(sr_final, hr_img)
        avg_ssim += Metrics.calculate_ssim(sr_final, hr_img)

    avg_psnr, avg_ssim = avg_psnr / max(idx, 1), avg_ssim / max(idx, 1)
    logger.info('# Validation # PSNR: {:.4e}'.format(avg_psnr))
    logger.info('# Validation # SSIM: {:.4e}'.format(avg_ssim))
    logging.getLogger('val').info(
        '<epoch:{:3d}, iter:{:8,d}> psnr: {:.4e}, ssim: {:.4e}'.format(
            0, 0, avg_psnr, avg_ssim))
    return avg_psnr, avg_ssim


def main(argv=None):
    args = _parser().parse_args(argv)
    _refuse(args)

    import torch

    from ucdir_tpu_torch import config as Logger
    from ucdir_tpu_torch import data as Data
    from ucdir_tpu_torch.metrics import core as Metrics
    from ucdir_tpu_torch.trainer import create_model
    from ucdir_tpu_torch.utils.logging import setup_logger

    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('--device %s, but CUDA is not available; pass '
                           '--device cpu to run the plain versions'
                           % args.device)
    # full float32 in cuDNN's convolutions and in matmuls (no TF32), so the
    # card computes what the CPU and the JAX reference compute
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(args.seed)

    opt = Logger.parse(args.config, phase=args.phase,
                       checkpoint=args.checkpoint, debug=args.debug,
                       num_processes=1)
    opt['sampler'] = args.sampler
    opt['sampling_timesteps'] = args.sampling_timesteps
    opt['compute_dtype'] = args.compute_dtype
    setup_logger('base', opt['path']['log'], 'train', level=logging.INFO,
                 screen=True)
    setup_logger('val', opt['path']['log'], 'val', level=logging.INFO)
    logger = logging.getLogger('base')
    logger.info(Logger.dict2str(opt))

    train_loader = None
    if args.phase == 'train':
        train_opt = opt['datasets']['train']
        train_set = Data.create_dataset(train_opt, 'train')
        train_loader = Data.create_dataloader(train_set, train_opt, 'train',
                                              seed=args.seed)
    val_opt = opt['datasets']['val']
    val_set = Data.create_dataset(val_opt, 'val')
    val_loader = Data.create_dataloader(val_set, val_opt, 'val')
    logger.info('Initial Dataset Finished')
    diffusion = create_model(opt, device=args.device, seed=args.seed)
    logger.info('Initial Model Finished')

    if args.phase == 'train':
        return _train(opt, diffusion, train_loader, val_loader, Metrics,
                      logger)
    if args.search_params:
        logger.info('Begin Model Evaluation. len ' + str(len(val_loader)))
        return search_params(
            opt, val_loader, diffusion, Metrics, logger,
            n_timesteps=tuple(int(s) for s in args.search_steps.split(',')),
            linear_ends=tuple(float(s) for s in args.search_ends.split(',')))
    if args.val_patch:
        logger.info('Begin Model Evaluation. len ' + str(len(val_loader)))
        return val_patch(opt, val_loader, val_set, diffusion, Metrics, logger,
                         skip=args.patch_skip, padding=args.patch_padding)
    return _validate(opt, diffusion, val_loader, val_set, Metrics, logger)


if __name__ == '__main__':
    main()
