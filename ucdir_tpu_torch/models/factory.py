"""Network factory — `define_G` for the SID configuration. Counterpart of
`ucdir_tpu/models/factory.py` (reference: model/networks.py:88-95)."""
from __future__ import annotations

import os
from typing import Any, Dict

from ucdir_tpu_torch.models.dy3h import DY3h


def tail_from_env() -> str:
    """The AKGM tail the environment asks for, by the JAX package's own two
    switches: UCDIR_TPU_NO_FUSED_TAIL=1 -> 'mix' (it wins where both are
    set, as there), UCDIR_TPU_AKGM_PACKED=1 -> 'packed', else 'fused'."""
    if os.environ.get('UCDIR_TPU_NO_FUSED_TAIL') == '1':
        return 'mix'
    if os.environ.get('UCDIR_TPU_AKGM_PACKED') == '1':
        return 'packed'
    return 'fused'


def define_G(opt: Dict[str, Any]):
    """The diffusion module of a parsed config (opt['model']): DY3h inside
    ResiGaussianGuideDY, the pair this port carries. The AKGM tail is the
    config's `unet.tail` or, without one, `tail_from_env()`, read once
    here."""
    from ucdir_tpu_torch.diffusion.base import ResiGaussianGuideDY

    model_opt = opt['model']
    if model_opt['which_model_G'] != 'ucdir':
        raise ValueError('which_model_G must be ucdir, got %r'
                         % model_opt['which_model_G'])
    unet_name = model_opt.get('unet_name') or 'DY3h'
    diffusion_name = model_opt.get('diffusion_name') or 'GaussianDiffusion'
    if unet_name != 'DY3h' or diffusion_name != 'ResiGaussianGuideDY':
        raise NotImplementedError(
            'the port carries DY3h in ResiGaussianGuideDY (the SID '
            'configuration), not %s in %s; see ROADMAP.md'
            % (unet_name, diffusion_name))
    unet_cfg = {k: v for k, v in dict(model_opt['unet']).items()
                if v is not None}
    unet_cfg['channel_mults'] = tuple(unet_cfg.get('channel_mults')
                                      or (1, 2, 4, 8, 8))
    unet_cfg['attn_res'] = tuple(unet_cfg.get('attn_res') or (8,))
    unet_cfg.setdefault('image_size', model_opt['diffusion']['image_size'])
    unet_cfg.setdefault('tail', tail_from_env())
    diff_cfg = dict(model_opt['diffusion'])
    return ResiGaussianGuideDY(
        denoise_fn=DY3h(**unet_cfg),
        image_size=diff_cfg.get('image_size', 128),
        channels=diff_cfg.get('channels', 3),
        conditional=bool(diff_cfg.get('conditional', True)))
