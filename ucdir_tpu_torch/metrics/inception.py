"""InceptionV3 (the FID variant) in PyTorch. Counterpart of
`ucdir_tpu/metrics/inception.py` (reference: clean-fid's InceptionV3 pool3
features, the reference's eval1.py:246-250).

The architecture of pytorch-fid's FIDInceptionV3: the tf-style InceptionV3
with the FID tweaks, count-exclude-padding average pooling in the InceptionA
and InceptionC pool branches, and the two InceptionE blocks with an average
(Mixed_7b) and a max (Mixed_7c) pool branch. Every BatchNorm is folded into
a per-channel `bn_scale` and `bn_bias`, as the JAX tree holds them
(eps 1e-3, `convert_inception_torch`).

No weights ship with the port and none are downloaded: they load from a
pytorch-fid or torchvision state dict (.pth) or the JAX package's converted
.npz, named by `UCDIR_TPU_INCEPTION_NPZ` or by the caller. The
convolutions are PyTorch's (cuDNN on the card; no Pallas kernel computes
Inception), with TF32 off where the caller sets it (`eval1.main`).

Input: NHWC images, uint8 / [0, 255] or [0, 1] floats; `preprocess` resizes
them to 299 x 299 (bilinear, no antialias, as `jax.image.resize`) and
scales them to [-1, 1]. Output: 2048-d pool3 features. The module computes
in NCHW and takes NHWC at its forward, the JAX package's layout.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class BasicConv(nn.Module):
    """Conv (no bias) + the folded inference BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.relu(self.conv(x) * self.bn_scale[None, :, None, None]
                      + self.bn_bias[None, :, None, None])


def _avg_pool_cep(x):
    """3x3, stride 1 average pool that counts only the pixels inside."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool_cep(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, 'branch7x7dbl_%d' % i)(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_cep(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, 'branch7x7x3_%d' % i)(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode  # 'avg' (Mixed_7b) or 'max' (Mixed_7c)
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (_avg_pool_cep(x) if self.pool_mode == 'avg'
              else F.max_pool2d(x, 3, 1, 1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """pool3 (2048-d) feature extractor: x (N, 299, 299, 3) NHWC in
    [-1, 1] -> (N, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, 'avg')
        self.Mixed_7c = InceptionE(2048, 'max')

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a',
                     'Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e',
                     'Mixed_7a', 'Mixed_7b', 'Mixed_7c'):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def preprocess(images, device=None) -> torch.Tensor:
    """NHWC uint8 / [0, 255] or [0, 1] float -> (N, 299, 299, 3) float32 in
    [-1, 1] on `device` (the images' own for a tensor, else the CPU): the
    batch divided by 255 where its largest value exceeds 1.5, resized
    bilinearly without antialias, as `jax.image.resize(..., antialias=False)`
    does (half-pixel centres; the edge samples' weights renormalized, which
    equals clamping for bilinear)."""
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                        else images)
    x = x.to(device=device if device is not None else x.device,
             dtype=torch.float32)
    if x.max() > 1.5:
        x = x / 255.
    if tuple(x.shape[1:3]) != (299, 299):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299),
                          mode='bilinear', align_corners=False,
                          antialias=False).permute(0, 2, 3, 1)
    return x * 2. - 1.


def convert_inception_torch(state_dict) -> Dict[str, torch.Tensor]:
    """A pytorch-fid / torchvision inception_v3 state dict -> the port's
    (`InceptionV3Features` plus `fc.weight`, `fc.bias` where the head is
    there), each BatchNorm folded into bn_scale = gamma / sqrt(var + 1e-3)
    and bn_bias = beta - mean * bn_scale in float32, as the JAX package
    folds it."""
    out: Dict[str, torch.Tensor] = {}

    def t(k):
        return torch.as_tensor(state_dict[k]).detach().cpu().float()

    prefixes = sorted({k.rsplit('.', 2)[0] for k in state_dict
                       if k.endswith('conv.weight')})
    for pref in prefixes:
        scale = t(pref + '.bn.weight') / torch.sqrt(
            t(pref + '.bn.running_var') + 1e-3)
        out[pref + '.conv.weight'] = t(pref + '.conv.weight')
        out[pref + '.bn_scale'] = scale
        out[pref + '.bn_bias'] = (t(pref + '.bn.bias')
                                  - t(pref + '.bn.running_mean') * scale)
    if 'fc.weight' in state_dict:
        out['fc.weight'] = t('fc.weight')
        out['fc.bias'] = t('fc.bias')
    return out


def load_inception_params(path: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """The weights at `path` or UCDIR_TPU_INCEPTION_NPZ as the port's state
    dict: the JAX package's converted .npz (its tree, '/'-joined keys), or a
    pytorch-fid / torchvision state dict (.pth). Raises where neither names
    an existing file."""
    path = path or os.environ.get('UCDIR_TPU_INCEPTION_NPZ')
    if not path or not os.path.exists(path):
        raise RuntimeError(
            'InceptionV3 weights unavailable. Save a pytorch-fid/torchvision '
            'inception state_dict (.pth) or a converted .npz and point '
            'UCDIR_TPU_INCEPTION_NPZ at it.')
    if path.endswith('.npz'):
        from ucdir_tpu_torch.utils.convert_jax import inception_from_jax
        tree: Dict = {}
        for k, v in np.load(path).items():
            node = tree
            parts = k.split('/')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return inception_from_jax(tree)
    return convert_inception_torch(
        torch.load(path, map_location='cpu', weights_only=True))


def _device(device) -> torch.device:
    """The device to run on: CUDA unless the caller names another; CUDA
    with no card raises, nothing falls back to the CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is unavailable: pass device="cpu" to run '
                           'on the CPU')
    return device


def _features_model(params: Dict[str, torch.Tensor], device):
    model = InceptionV3Features()
    model.load_state_dict({k: v for k, v in params.items()
                           if not k.startswith('fc.')})
    return model.to(device).eval().requires_grad_(False)


def _batched(fn, images, batch_size):
    with torch.no_grad():
        return np.concatenate([fn(images[i:i + batch_size])
                               for i in range(0, len(images), batch_size)],
                              axis=0)


def _classifier(params: Dict[str, torch.Tensor], device):
    """fn(images NHWC) -> (N, 1000) softmax class probabilities as numpy:
    pool3 features through the torchvision fc head of `params`."""
    if 'fc.weight' not in params:
        raise RuntimeError('params lack the fc head — convert a full '
                           'torchvision inception_v3 state_dict (not the '
                           'headless pytorch-fid variant) for IS.')
    model = _features_model(params, device)
    w, b = params['fc.weight'].to(device), params['fc.bias'].to(device)
    return lambda x: torch.softmax(model(preprocess(x, device)) @ w.t() + b,
                                   dim=-1).cpu().numpy()


def inception_probs(params: Dict[str, torch.Tensor], images,
                    device=None) -> np.ndarray:
    """Softmax class probabilities (N, 1000), the classifier head the
    reference's inception score uses (its eval1.py:74-130). `params`: a
    state dict of `convert_inception_torch` INCLUDING the fc head. Feed the
    result to `metrics.fid.inception_score`."""
    with torch.no_grad():
        return _classifier(params, _device(device))(images)


def make_feature_fn(path: Optional[str] = None, batch_size: int = 64,
                    device=None):
    """Returns fn(images NHWC) -> (N, 2048) pool3 features as numpy, in
    batches of `batch_size`, each preprocessed on its own, on `device`
    (CUDA unless named)."""
    device = _device(device)
    model = _features_model(load_inception_params(path), device)
    return lambda images: _batched(
        lambda x: model(preprocess(x, device)).cpu().numpy(), images,
        batch_size)


def make_classifier_fn(path: Optional[str] = None, batch_size: int = 64,
                       device=None):
    """Returns fn(images NHWC) -> (N, 1000) softmax class probabilities in
    batches, pool3 features through the torchvision fc head (the reference's
    inception-score classifier, eval1.py:74-130 / :106). Requires a state
    dict that includes fc.weight and fc.bias."""
    fn = _classifier(load_inception_params(path), _device(device))
    return lambda images: _batched(fn, images, batch_size)
