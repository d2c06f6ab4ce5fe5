"""W&B logger. Counterpart of `ucdir_tpu/utils/wandb_logger.py` (reference
core/wandb_logger.py:3-117).

Needs the `wandb` package: construction raises ImportError without it,
which `sr.py` catches and logs, training on.
"""
from __future__ import annotations

import os


class WandbLogger:
    """Logs metrics, images, evaluation tables and checkpoints to W&B."""

    def __init__(self, opt):
        import wandb  # raises ImportError where the package is absent
        self._wandb = wandb
        if wandb.run is None:
            wandb.init(project=(opt.get('wandb') or {}).get('project',
                                                           'ucdir_tpu'),
                       config=dict(opt), dir='./experiments')
        self.config = wandb.config
        self._ckpt_dir = (opt.get('path') or {}).get('checkpoint') or ''
        self.eval_table = self.infer_table = None
        if self.config.get('log_eval', None):
            self.eval_table = wandb.Table(
                columns=['fake_image', 'sr_image', 'hr_image', 'psnr',
                         'ssim'])
        elif self.config.get('log_infer', None):
            self.infer_table = wandb.Table(
                columns=['fake_image', 'sr_image', 'hr_image'])

    def log_metrics(self, metrics, commit=True):
        self._wandb.log(metrics, commit=commit)

    def log_image(self, key_name, image_array):
        self._wandb.log({key_name: self._wandb.Image(image_array)})

    def log_images(self, key_name, list_images):
        self._wandb.log({key_name: [self._wandb.Image(im)
                                    for im in list_images]})

    def log_checkpoint(self, current_epoch, current_step):
        """Uploads a saved checkpoint triple (`utils/checkpoint.py`:
        I{step}_E{epoch}_{gen,gen_ema,opt}.pth, or the periodic
        I_Elatest one) as a W&B model artifact."""
        artifact = self._wandb.Artifact(self._wandb.run.id + '_model',
                                        type='model')
        tag = 'I{}_E{}'.format(current_step, current_epoch)
        prefix = os.path.join(self._ckpt_dir, tag)
        if not os.path.isfile(prefix + '_gen.pth'):
            prefix = os.path.join(self._ckpt_dir, 'I_Elatest')
        for part in ('gen', 'gen_ema', 'opt'):
            path = '{}_{}.pth'.format(prefix, part)
            if os.path.isfile(path):
                artifact.add_file(path)
        self._wandb.log_artifact(artifact, aliases=['latest', tag])

    def log_eval_data(self, fake_img, sr_img, hr_img, psnr=None, ssim=None):
        if self.eval_table is not None:
            self.eval_table.add_data(
                self._wandb.Image(fake_img), self._wandb.Image(sr_img),
                self._wandb.Image(hr_img), psnr, ssim)
        elif self.infer_table is not None:
            self.infer_table.add_data(
                self._wandb.Image(fake_img), self._wandb.Image(sr_img),
                self._wandb.Image(hr_img))

    def log_eval_table(self, commit=False):
        if self.eval_table is not None:
            self._wandb.log({'eval_data': self.eval_table}, commit=commit)
        elif self.infer_table is not None:
            self._wandb.log({'infer_data': self.infer_table}, commit=commit)
