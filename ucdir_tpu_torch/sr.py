"""Train and validation entry point of the port, with the CLI names, cadences
and result files of the repo's `sr.py`:

    python -m ucdir_tpu_torch.sr -p train -c ucdir_tpu/configs/sid.yaml \\
        [--seed N] [--device cuda] [-debug]
    python -m ucdir_tpu_torch.sr -p val -c ucdir_tpu/configs/sid.yaml \\
        [--checkpoint <prefix>] [--seed N] [--device cuda]

Training saves the reference's checkpoint triple
`I{iter}_E{epoch}_{gen,gen_ema,opt}.pth` and resumes from the prefix in the
config's `path.resume_state`; `-p val --checkpoint <prefix>` validates a
triple's EMA weights. Without a checkpoint the model starts from the random
weights of --seed. One process, one card, fp32.
"""
from __future__ import annotations

import argparse
import logging
import os


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
    p.add_argument('--compute_dtype', type=str, default=None,
                   choices=['bf16'])
    p.add_argument('--val_batch', type=int, default=1)
    p.add_argument('--val_patch', action='store_true')
    p.add_argument('--search_params', action='store_true')
    p.add_argument('--seed', type=int, default=0,
                   help='seed of the random weights, of the training draws '
                        'and of the sampling noise')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default) or 'cpu' (the kernels' plain "
                        "versions)")
    return p


def _refuse(args):
    """NotImplementedError for every option the port does not carry yet."""
    todo = [(args.sampler != 'ddpm', 'the %s sampler' % args.sampler),
            (args.compute_dtype is not None, '--compute_dtype'),
            (args.val_batch > 1, '--val_batch > 1'),
            (args.val_patch, '--val_patch'),
            (args.search_params, '--search_params')]
    for hit, what in todo:
        if hit:
            raise NotImplementedError('%s is not ported yet; see ROADMAP.md'
                                      % what)


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
    from ucdir_tpu_torch.trainer import Trainer
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
    diffusion = Trainer(opt, device=args.device, seed=args.seed)
    logger.info('Initial Model Finished')

    if args.phase == 'train':
        return _train(opt, diffusion, train_loader, val_loader, Metrics,
                      logger)
    return _validate(opt, diffusion, val_loader, val_set, Metrics, logger)


if __name__ == '__main__':
    main()
