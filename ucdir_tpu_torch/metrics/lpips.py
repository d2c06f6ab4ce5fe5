"""LPIPS (Learned Perceptual Image Patch Similarity) with AlexNet features.
Counterpart of `ucdir_tpu/metrics/lpips.py` (reference: the `lpips`
package, which the perceptual training loss and eval1.py use).

No weights ship with the port and none are downloaded: they load from a
torch `lpips.LPIPS(net='alex')` state dict saved to disk
(`convert_lpips_torch`) or from the JAX package's converted .npz, named by
`UCDIR_TPU_LPIPS_WEIGHTS` or by the caller; without them `make_lpips`
raises with the JAX package's message.

The forward runs on PyTorch's convolutions and max pools (cuDNN on the
card), as the JAX package runs XLA's; it is differentiable, since the
perceptual loss back-propagates through it. Inputs are NHWC in [-1, 1];
they are taken in float32 whatever their dtype, as the JAX package's
float32 weights promote a bfloat16 input.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet's feature convolutions: (out_channels, kernel, stride, padding),
# a ReLU after each, max pool (3, 2) after the first two; LPIPS taps the five
# ReLU outputs
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
# lpips's ImageNet scaling layer
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)
# torchvision's features index of each convolution
_CONV_IDX = {0: 0, 3: 1, 6: 2, 8: 3, 10: 4}


def alex_features(x, weights: Dict[str, torch.Tensor]):
    """x (N, H, W, 3) NHWC in [-1, 1] -> the five tapped ReLU outputs, NCHW
    float32."""
    x = x.float().permute(0, 3, 1, 2)
    shift = x.new_tensor(_SHIFT)[None, :, None, None]
    scale = x.new_tensor(_SCALE)[None, :, None, None]
    x = (x - shift) / scale
    feats = []
    for i, (_, _, stride, pad) in enumerate(_ALEX_CFG):
        x = F.relu(F.conv2d(x, weights['conv%d_w' % i],
                            weights['conv%d_b' % i], stride=stride,
                            padding=pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def lpips_distance(x, y, weights: Dict[str, torch.Tensor]):
    """LPIPS per batch element, (N,) float32: per tap the channel-normalized
    features' squared difference, weighted by lin and summed over the
    channels, averaged over the pixels, then summed over the taps."""
    total = 0.
    for i, (a, b) in enumerate(zip(alex_features(x, weights),
                                   alex_features(y, weights))):
        a = a / (torch.sqrt((a * a).sum(dim=1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt((b * b).sum(dim=1, keepdim=True)) + 1e-10)
        d = (a - b) ** 2 * weights['lin%d_w' % i][None, :, None, None]
        total = total + d.sum(dim=1).mean(dim=(1, 2))
    return total


def convert_lpips_torch(state_dict) -> Dict[str, torch.Tensor]:
    """A torch lpips.LPIPS(net='alex') state dict -> the weights this module
    takes: conv{i}_w (O, I, kh, kw), conv{i}_b, lin{i}_w (C,), float32."""
    out = {}
    for k, v in state_dict.items():
        v = torch.as_tensor(v).detach().cpu().float()
        if k.startswith('net.slice'):
            # net.slice<N>.<idx>.weight, idx the features index
            idx = int(k.split('.')[2])
            if idx in _CONV_IDX:
                tag = 'conv%d' % _CONV_IDX[idx]
                out[tag + ('_w' if k.endswith('.weight') else '_b')] = v
        elif k.startswith('lin') and k.endswith('.model.1.weight'):
            out['lin%s_w' % k[3]] = v.reshape(-1)    # (1, C, 1, 1) -> (C,)
    return out


def load_lpips_weights(path: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """The weights at `path` or UCDIR_TPU_LPIPS_WEIGHTS: a torch lpips
    state dict, or the JAX package's .npz (HWIO kernels). Raises where
    neither names an existing file."""
    path = path or os.environ.get('UCDIR_TPU_LPIPS_WEIGHTS')
    if not path or not os.path.exists(path):
        raise RuntimeError(
            'LPIPS weights unavailable. Save a torch lpips state_dict '
            "(torch.save(lpips.LPIPS(net='alex').state_dict(), p)) or a "
            'converted .npz, and point UCDIR_TPU_LPIPS_WEIGHTS at it.')
    if path.endswith('.npz'):
        from ucdir_tpu_torch.utils.convert_jax import lpips_from_jax
        return lpips_from_jax(dict(np.load(path)))
    return convert_lpips_torch(torch.load(path, map_location='cpu',
                                          weights_only=True))


class LPIPS:
    """fn(x, y) -> (N,) LPIPS on fixed weights, moved to the inputs' device
    at first use there. A plain object, not an nn.Module: a model that holds
    it keeps it out of its state dict and its optimizer."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        self.weights = {k: torch.as_tensor(v).float()
                        for k, v in weights.items()}
        self._on = {}

    def __call__(self, x, y):
        w = self._on.get(x.device)
        if w is None:
            w = self._on[x.device] = {k: v.to(x.device)
                                      for k, v in self.weights.items()}
        return lpips_distance(x, y, w)


def make_lpips(path: Optional[str] = None) -> LPIPS:
    """The LPIPS callable on the weights of `load_lpips_weights(path)`."""
    return LPIPS(load_lpips_weights(path))
