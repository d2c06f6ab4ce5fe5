"""The validation step. Counterpart of `make_eval_step` in
`ucdir_tpu/train/step.py` (reference: model/model.py:124-138): reflect-pad
the degraded input by 64, restore the image (whole, or tiled inside every
denoising step when it is large), crop the pad back off."""
from __future__ import annotations

from typing import Optional

import torch

from ucdir_tpu_torch.diffusion.sampler import (UNTILED_MAX_PX, Noise,
                                               super_resolution)
from ucdir_tpu_torch.models.layers import reflect_pad
from ucdir_tpu_torch.schedule import NoiseSchedule


def should_tile(h: int, w: int, tile: Optional[dict]) -> bool:
    """Whether a padded h x w input runs the tiled denoiser. With a tile dict
    (the CLI, the tests): everything above skip x skip, the reference's rule.
    Without one: the whole image while it fits the card, so only inputs
    above UNTILED_MAX_PX (no overlap to recompute, no halo effects)."""
    skip = int((tile or {}).get('skip', 1024))
    if h * w <= skip * skip:
        return False
    return tile is not None or h * w > UNTILED_MAX_PX


def eval_step(model, sched: NoiseSchedule, sr_img: torch.Tensor, *,
              pad: int = 64, continous: bool = False,
              noise: Optional[Noise] = None,
              generator: Optional[torch.Generator] = None,
              sampler: str = 'ddpm', sampling_timesteps: int = 5,
              tile: Optional[dict] = None,
              compute_dtype: Optional[torch.dtype] = None):
    """sr_img (B, H, W, 3) in [-1, 1] -> (sr, initx) or (sr, initx,
    snapshots), each cropped back to H x W. tile: {skip, padding,
    tile_chunk} for the tiled path (defaults 1024, 64, 1). compute_dtype:
    the networks' dtype (None: the weights', float32), as
    `super_resolution` takes it; the results are float32."""
    x = reflect_pad(sr_img, pad, pad, pad, pad) if pad else sr_img
    tile_opts = None
    if should_tile(x.shape[1], x.shape[2], tile):
        tile_opts = {'skip': 1024, 'padding': 64, 'tile_chunk': 1,
                     **(tile or {})}
    out = super_resolution(model, sched, x, noise=noise, generator=generator,
                           continous=continous, sampler=sampler,
                           sampling_timesteps=sampling_timesteps,
                           tile_opts=tile_opts, compute_dtype=compute_dtype)
    if pad:
        out = tuple(o[..., pad:-pad, pad:-pad, :] for o in out)
    return out
