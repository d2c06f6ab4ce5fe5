"""Network factory — `define_G`. Counterpart of
`ucdir_tpu/models/factory.py` (reference: model/networks.py:88-95)."""
from __future__ import annotations

import os
from typing import Any, Dict

from ucdir_tpu_torch.models.dy3h import DY3h
from ucdir_tpu_torch.ops.gn_scope import gn_scope_from_env

UNETS = {'DY3h': DY3h}


def tail_from_env() -> str:
    """The AKGM tail the environment asks for, by the JAX package's own two
    switches: UCDIR_TPU_NO_FUSED_TAIL=1 -> 'mix' (it wins where both are
    set, as there), UCDIR_TPU_AKGM_PACKED=1 -> 'packed', else 'fused'."""
    if os.environ.get('UCDIR_TPU_NO_FUSED_TAIL') == '1':
        return 'mix'
    if os.environ.get('UCDIR_TPU_AKGM_PACKED') == '1':
        return 'packed'
    return 'fused'


def resident_from_env() -> bool:
    """Whether tiled DDPM keeps its state tiled (parallel/resident.py):
    yes unless UCDIR_TPU_NO_RESIDENT=1, the JAX package's switch."""
    return os.environ.get('UCDIR_TPU_NO_RESIDENT') != '1'


def define_G(opt: Dict[str, Any]):
    """The diffusion module of a parsed config (opt['model']): the
    `diffusion_name` class of DIFFUSIONS (default GaussianDiffusion) around
    the `unet_name` network of UNETS (default DY3h), the JAX package's
    defaults. The AKGM tail is the config's `unet.tail` or, without one,
    `tail_from_env()`, read once here; so are the GroupNorm(1) scope and
    window (`unet.gn_scope`, `unet.gn_tile`, else UCDIR_TPU_GN_SCOPE and
    UCDIR_TPU_GN_TILE, ops/gn_scope.py), and the model's `resident`
    (`resident_from_env`). PerceptualGaussianDiffusion loads
    its LPIPS from `model.lpips_weights` or UCDIR_TPU_LPIPS_WEIGHTS and
    raises without them."""
    from ucdir_tpu_torch.diffusion.base import DIFFUSIONS

    model_opt = opt['model']
    if model_opt['which_model_G'] != 'ucdir':
        raise ValueError('which_model_G must be ucdir, got %r'
                         % model_opt['which_model_G'])
    unet_name = model_opt.get('unet_name') or 'DY3h'
    diffusion_name = model_opt.get('diffusion_name') or 'GaussianDiffusion'
    for name, known in ((unet_name, UNETS), (diffusion_name, DIFFUSIONS)):
        if name not in known:
            raise KeyError('%r: expected one of %s' % (name, sorted(known)))
    unet_cfg = {k: v for k, v in dict(model_opt['unet']).items()
                if v is not None}
    unet_cfg['channel_mults'] = tuple(unet_cfg.get('channel_mults')
                                      or (1, 2, 4, 8, 8))
    unet_cfg['attn_res'] = tuple(unet_cfg.get('attn_res') or (8,))
    unet_cfg.setdefault('image_size', model_opt['diffusion']['image_size'])
    unet_cfg.setdefault('tail', tail_from_env())
    scope, tile = gn_scope_from_env()
    unet_cfg.setdefault('gn_scope', scope)
    unet_cfg.setdefault('gn_tile', tile)
    diff_cfg = dict(model_opt['diffusion'])
    perceptual_fn = None
    if diffusion_name == 'PerceptualGaussianDiffusion':
        from ucdir_tpu_torch.metrics.lpips import make_lpips
        perceptual_fn = make_lpips(model_opt.get('lpips_weights'))
    model = DIFFUSIONS[diffusion_name](
        denoise_fn=UNETS[unet_name](**unet_cfg),
        image_size=diff_cfg.get('image_size', 128),
        channels=diff_cfg.get('channels', 3),
        loss_type=diff_cfg.get('loss_type', 'l1'),
        conditional=bool(diff_cfg.get('conditional', True)),
        perceptual_fn=perceptual_fn)
    model.resident = resident_from_env()
    return model
