"""The residual guided diffusion variant of the SID configuration.
Counterpart of `ucdir_tpu/diffusion/base.py` (reference:
model/diffusion.py:436-478). Its state dict is the reference's:
`denoise_fn.*` (DY3h) and `predictor.*` (UNetSeeInDark).
"""
from __future__ import annotations

import torch
from torch import nn

from ucdir_tpu_torch.models.seeindark import UNetSeeInDark


class ResiGaussianGuideDY(nn.Module):
    """Diffusion over the residual HR - predictor(SR); the predictor's output
    `initx` also guides every AKGM block while sampling."""
    has_predictor = True
    guide_in_sample = 'initx'

    def __init__(self, denoise_fn: nn.Module, image_size: int = 128,
                 channels: int = 3, conditional: bool = True):
        super().__init__()
        if not conditional:
            raise NotImplementedError('unconditional sampling is not '
                                      'ported; see ROADMAP.md')
        self.denoise_fn = denoise_fn
        self.predictor = UNetSeeInDark()
        self.image_size = image_size
        self.channels = channels

    def denoise(self, x, noise_level, guide, guide_maps=None,
                dropout_generator=None):
        """One eps prediction. x (B, H, W, 6) is [condition, noisy image];
        noise_level (B, 1); guide (B, H, W, 3)."""
        return self.denoise_fn(x, noise_level, guide, guide_maps=guide_maps,
                               dropout_generator=dropout_generator)

    def predict_init(self, x):
        return self.predictor(x)

    @staticmethod
    def q_sample(x_start, continuous_sqrt_alpha_cumprod, noise):
        """Forward noising with the continuous gamma (reference
        diffusion.py:306-313)."""
        g = continuous_sqrt_alpha_cumprod
        return g * x_start + torch.sqrt(1 - g ** 2) * noise

    def p_losses(self, x_in, gammas, noise, dropout_generator=None):
        """The training loss, L1 summed over every element (the trainer
        divides by b * c * h * w). x_in: {'HR', 'SR'} (B, H, W, C); gammas
        (B, 1); noise like HR. The diffusion runs over HR - initx, and initx,
        not detached, guides the denoiser: the loss trains the predictor
        too. Dropout follows self.training. Everything runs in the dtype of
        the inputs and the parameters (bf16 under a mixed-precision train
        step, `q_sample` included) but the loss: the L1 sum is taken in
        float32."""
        x_init = self.predictor(x_in['SR'])
        x_start = x_in['HR'] - x_init
        x_noisy = self.q_sample(x_start, gammas.reshape(-1, 1, 1, 1), noise)
        net_in = torch.cat([x_in['SR'], x_noisy], dim=-1)
        x_recon = self.denoise(net_in, gammas, x_init,
                               dropout_generator=dropout_generator)
        return (noise.float() - x_recon.float()).abs().sum()

    def forward(self, x_in, gammas, noise, dropout_generator=None):
        return self.p_losses(x_in, gammas, noise, dropout_generator)
