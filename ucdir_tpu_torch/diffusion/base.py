"""The diffusion variants. Counterpart of `ucdir_tpu/diffusion/base.py`
(reference: model/diffusion.py:73-662). Each owns the denoiser
(`denoise_fn`, DY3h) and, for the residual variants and NoDiffusion, the
predictor (`predictor`, UNetSeeInDark), so the state dict is the
reference's: `denoise_fn.*` and `predictor.*`.

The variants differ by a few hooks, as in the JAX package:
  * `has_predictor`: a predictor makes initx = predictor(SR);
  * `_x_start`: what is diffused (HR, or the residual HR - initx);
  * `_train_guide` / `guide_in_sample`: what guides the AKGM blocks in
    training / sampling ('initx', 'degraded' the degraded input, or None);
  * `_extra_loss`: a term added to the noise loss;
  * `sample_mode`: 'reverse' (the reverse process) or 'refine' (NoDiffusion:
    one denoiser pass at a fixed noise level, `refine`).

With no guide the denoiser is guided by `x[..., :3]` of its own input: the
condition for a conditional model, the noisy image itself for an
unconditional one, initx for NoDiffusion.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ucdir_tpu_torch.models.seeindark import UNetSeeInDark


def pixel_loss(loss_type: str, a, b):
    """The summed 'l1' or 'l2' loss of a and b, in float32 whatever their
    dtype (bf16 sums drift)."""
    d = a.float() - b.float()
    if loss_type == 'l1':
        return d.abs().sum()
    if loss_type == 'l2':
        return (d * d).sum()
    raise NotImplementedError(loss_type)


class GaussianDiffusion(nn.Module):
    """The conditional (or, with conditional=False, unconditional) DDPM of
    the reference (diffusion.py:73-343)."""
    has_predictor = False
    guide_in_train: Optional[str] = None
    guide_in_sample: Optional[str] = None
    sample_mode = 'reverse'
    # tiled DDPM keeps its state tiled (parallel/resident.py); define_G sets
    # it from UCDIR_TPU_NO_RESIDENT
    resident = True

    def __init__(self, denoise_fn: nn.Module, image_size: int = 128,
                 channels: int = 3, loss_type: str = 'l1',
                 conditional: bool = True,
                 perceptual_fn: Optional[Callable] = None):
        """perceptual_fn: fn(pred, target) -> (B,) distances, the
        perceptual variant's LPIPS (metrics/lpips.py); kept as a plain
        attribute, so it is no part of the state dict."""
        super().__init__()
        if loss_type not in ('l1', 'l2'):
            raise NotImplementedError(loss_type)
        self.denoise_fn = denoise_fn
        if self.has_predictor:
            self.predictor = UNetSeeInDark()
        self.image_size = image_size
        self.channels = channels
        self.loss_type = loss_type
        self.conditional = conditional
        self.perceptual_fn = perceptual_fn

    def denoise(self, x, noise_level, guide=None, guide_maps=None,
                dropout_generator=None):
        """One eps prediction. x (B, H, W, in_channel): [condition, noisy
        image] for a conditional model, else the noisy image; noise_level
        (B, 1); guide (B, H, W, 3), or None for x[..., :3]."""
        if guide is None:
            guide = x[..., :3]
        return self.denoise_fn(x, noise_level, guide, guide_maps=guide_maps,
                               dropout_generator=dropout_generator)

    def predict_init(self, x):
        if not self.has_predictor:
            raise NotImplementedError('no predictor in %s'
                                      % type(self).__name__)
        return self.predictor(x)

    @staticmethod
    def q_sample(x_start, continuous_sqrt_alpha_cumprod, noise):
        """Forward noising with the continuous gamma (reference
        diffusion.py:306-313)."""
        g = continuous_sqrt_alpha_cumprod
        return g * x_start + torch.sqrt(1 - g ** 2) * noise

    # the per-variant hooks
    def _x_start(self, x_in, x_init):
        return x_in['HR']

    def _train_guide(self, x_in, x_init):
        return {'initx': x_init, 'degraded': x_in['SR'],
                None: None}[self.guide_in_train]

    def _extra_loss(self, x_in, x_init, x_recon, x_noisy, gammas):
        return None

    def _x_start_recon(self, x_noisy, x_recon, gammas):
        """x0 from the noisy image and the predicted noise."""
        f = gammas.reshape(-1, 1, 1, 1)
        return (x_noisy - torch.sqrt(1 - f ** 2) * x_recon) / f

    def p_losses(self, x_in, gammas, noise, dropout_generator=None):
        """The training loss, summed over every element (the trainer divides
        by b * c * h * w). x_in: {'HR', 'SR'} (B, H, W, C); gammas (B, 1);
        noise like HR. Where a predictor's initx is diffused against or
        guides, it is not detached: the loss trains the predictor too.
        Dropout follows self.training. Everything runs in the dtype of the
        inputs and the parameters (bf16 under a mixed-precision train step)
        but the losses, which are summed in float32."""
        x_init = self.predictor(x_in['SR']) if self.has_predictor else None
        x_noisy = self.q_sample(self._x_start(x_in, x_init),
                                gammas.reshape(-1, 1, 1, 1), noise)
        net_in = (torch.cat([x_in['SR'], x_noisy], dim=-1)
                  if self.conditional else x_noisy)
        x_recon = self.denoise(net_in, gammas, self._train_guide(x_in, x_init),
                               dropout_generator=dropout_generator)
        loss = pixel_loss(self.loss_type, noise, x_recon)
        extra = self._extra_loss(x_in, x_init, x_recon, x_noisy, gammas)
        return loss if extra is None else loss + extra

    def forward(self, x_in, gammas, noise, dropout_generator=None):
        return self.p_losses(x_in, gammas, noise, dropout_generator)


class PerceptualGaussianDiffusion(GaussianDiffusion):
    """+ the LPIPS of the reconstructed x0 against HR (diffusion.py:
    348-387)."""

    def _extra_loss(self, x_in, x_init, x_recon, x_noisy, gammas):
        if self.perceptual_fn is None:
            raise ValueError(
                'PerceptualGaussianDiffusion needs perceptual_fn (an LPIPS '
                'callable, see ucdir_tpu_torch.metrics.lpips).')
        return self.perceptual_fn(
            self._x_start_recon(x_noisy, x_recon, gammas), x_in['HR']).sum()


class ResiGaussianDiffusion(GaussianDiffusion):
    """Diffusion over the residual HR - predictor(SR) (diffusion.py:
    393-432)."""
    has_predictor = True

    def _x_start(self, x_in, x_init):
        return x_in['HR'] - x_init


class ResiGaussianGuideDY(ResiGaussianDiffusion):
    """The residual, with initx guiding every AKGM block (diffusion.py:
    436-478): the SID configuration."""
    guide_in_train = 'initx'
    guide_in_sample = 'initx'


class ResiGaussianGuideDY_de(ResiGaussianDiffusion):
    """The residual, with the degraded input guiding (diffusion.py:
    481-523)."""
    guide_in_train = 'degraded'
    guide_in_sample = 'degraded'


class ResiGaussianGuideDY_initxloss(ResiGaussianGuideDY):
    """+ 0.5 * loss(initx, HR): the predictor supervised too (diffusion.py:
    528-571)."""

    def _extra_loss(self, x_in, x_init, x_recon, x_noisy, gammas):
        return 0.5 * pixel_loss(self.loss_type, x_init, x_in['HR'])


class ResiPercepGaussianDiffusion(ResiGaussianDiffusion):
    """+ 0.5 * loss(x0_recon + initx, HR) (diffusion.py:573-622): a pixel
    term, no LPIPS."""

    def _extra_loss(self, x_in, x_init, x_recon, x_noisy, gammas):
        return 0.5 * pixel_loss(
            self.loss_type,
            self._x_start_recon(x_noisy, x_recon, gammas) + x_init,
            x_in['HR'])


class NoDiffusion(GaussianDiffusion):
    """The ablation without diffusion (diffusion.py:625-662): the denoiser
    refines initx once at the fixed noise level sqrt_alphas_cumprod_prev[1]
    (the train step feeds that constant as gammas), with a regression loss
    against HR; sampling is one `refine` pass."""
    has_predictor = True
    sample_mode = 'refine'

    def p_losses(self, x_in, gammas, noise, dropout_generator=None):
        x_recon = self.denoise(self.predictor(x_in['SR']), gammas,
                               dropout_generator=dropout_generator)
        return pixel_loss(self.loss_type, x_in['HR'], x_recon)

    def refine(self, x_init, gammas):
        """The denoiser's pass over initx (B, H, W, 3) at noise level
        gammas (B, 1)."""
        return self.denoise(x_init, gammas)


DIFFUSIONS = {
    'GaussianDiffusion': GaussianDiffusion,
    'PerceptualGaussianDiffusion': PerceptualGaussianDiffusion,
    'ResiGaussianDiffusion': ResiGaussianDiffusion,
    'ResiGaussianGuideDY': ResiGaussianGuideDY,
    'ResiGaussianGuideDY_de': ResiGaussianGuideDY_de,
    'ResiGaussianGuideDY_initxloss': ResiGaussianGuideDY_initxloss,
    'ResiPercepGaussianDiffusion': ResiPercepGaussianDiffusion,
    'NoDiffusion': NoDiffusion,
}
