"""JAX params -> the port's state dict: the inverse of
`ucdir_tpu/utils/convert_torch.py`.

    flax HWIO conv kernel (kh, kw, I, O)        -> OIHW (O, I, kh, kw)
    grouped spdyconv kernel (3, 3, C/G, C*G)    -> (C*G, C/G, 3, 3)
    Dense kernel (I, O)                         -> Linear weight (O, I)
    GroupNorm scale                             -> weight
    ConvTranspose2x2 kernel (kh, kw, I, O)      -> (I, O, kh, kw)

Keys follow the reference module tree (`downs.<i>.res_block.conv1.weight`,
`final_conv.3.weight`, `predictor.upv6.weight`, ...). The plain SR3
`ResnetBlock` (`resname: ResnetBlock`) maps `block{1,2}/{norm,conv}` to
`block{1,2}.block.{0,3}` and `noise_func/noise_func` to
`noise_func.noise_func.0`; a network with no predictor has no
`predictor.*`. LPIPS and Inception weights convert apart (`lpips_from_jax`,
`inception_from_jax`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _conv(k):
    return np.asarray(k).transpose(3, 2, 0, 1)


def _dense(k):
    return np.asarray(k).transpose(1, 0)


def _convT(k):
    return np.asarray(k).transpose(2, 3, 0, 1)


def _kernel_bias(node, prefix, tf, out):
    out[prefix + 'weight'] = tf(node['kernel'])
    if 'bias' in node:
        out[prefix + 'bias'] = np.asarray(node['bias'])


def _norm(node, prefix, out):
    out[prefix + 'weight'] = np.asarray(node['scale'])
    out[prefix + 'bias'] = np.asarray(node['bias'])


def _res_block(p, prefix, out):
    for name, node in p.items():
        if name == 'noise_func':     # ResnetBlock's FeatureWiseAffine
            _kernel_bias(node['noise_func'],
                         prefix + 'noise_func.noise_func.0.', _dense, out)
        elif name in ('block1', 'block2'):     # ResnetBlock's Block
            _norm(node['norm'], '%s%s.block.0.' % (prefix, name), out)
            _kernel_bias(node['conv'], '%s%s.block.3.' % (prefix, name),
                         _conv, out)
        elif name.startswith('noise_func_'):
            _kernel_bias(node, '%snoise_func.%s.' % (prefix, name[-1]),
                         _dense, out)
        elif name in ('norm1', 'norm2'):
            _norm(node, prefix + name + '.', out)
        elif name in ('conv1', 'res_conv'):
            _kernel_bias(node, prefix + name + '.', _conv, out)
        elif name.startswith('conv2_'):
            _kernel_bias(node, '%sconv2.%s.' % (prefix, name[-1]), _conv, out)
        elif name == 'spdyconv_kernel':
            out[prefix + 'spdyconv.weight'] = _conv(node)
        elif name == 'spdyconv_bias':
            out[prefix + 'spdyconv.bias'] = np.asarray(node)
        else:
            raise KeyError('unmapped residual block param: %s%s'
                           % (prefix, name))


def _attention(p, prefix, out):
    _norm(p['norm'], prefix + 'norm.', out)
    _kernel_bias(p['qkv'], prefix + 'qkv.', _conv, out)
    _kernel_bias(p['out'], prefix + 'out.', _conv, out)


def _dy3h(p, prefix, out):
    for name, node in p.items():
        if name.startswith('noise_level_mlp_'):
            _kernel_bias(node, '%snoise_level_mlp.%s.' % (prefix, name[-1]),
                         _dense, out)
        elif name == 'final_conv_norm':
            _norm(node, prefix + 'final_conv.0.', out)
        elif name == 'final_conv_conv':
            _kernel_bias(node, prefix + 'final_conv.3.', _conv, out)
        elif name == 'downs_0':
            _kernel_bias(node, prefix + 'downs.0.', _conv, out)
        else:
            group, idx = name.rsplit('_', 1)
            if group not in ('downs', 'mid', 'ups'):
                raise KeyError('unmapped DY3h param: %s%s' % (prefix, name))
            base = '%s%s.%s.' % (prefix, group, idx)
            for sub, leaf in node.items():
                if sub == 'res_block':
                    _res_block(leaf, base + 'res_block.', out)
                elif sub == 'attn':
                    _attention(leaf, base + 'attn.', out)
                elif sub == 'conv':
                    _kernel_bias(leaf, base + 'conv.', _conv, out)
                else:
                    raise KeyError('unmapped DY3h param: %s%s' % (base, sub))


def _seeindark(p, prefix, out):
    for name, node in p.items():
        tf = _convT if name.startswith('upv') else _conv
        _kernel_bias(node, prefix + name + '.', tf, out)


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `{'denoise_fn': ..., 'predictor': ...}` param tree (arrays
    convertible with np.asarray) -> the port's state dict of float tensors."""
    out: Dict[str, np.ndarray] = {}
    _dy3h(params['denoise_fn'], 'denoise_fn.', out)
    if 'predictor' in params:
        _seeindark(params['predictor'], 'predictor.', out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def from_jax_grads(grads: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX gradient tree (the params' structure, arrays convertible with
    np.asarray) -> {state-dict name: numpy array in the port's layout}. Every
    layout change above is a permutation, so a gradient maps as its parameter
    does."""
    return {k: v.numpy() for k, v in from_jax_params(grads).items()}


def lpips_from_jax(weights: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS weights (`ucdir_tpu/metrics/lpips.py`: HWIO
    conv{i}_w, conv{i}_b, lin{i}_w, numpy) -> the port's
    (`ucdir_tpu_torch/metrics/lpips.py`: OIHW conv{i}_w), float32."""
    return {k: torch.from_numpy(np.array(_conv(v) if k.endswith('_w')
                                         and k.startswith('conv') else v,
                                         np.float32))
            for k, v in weights.items()}


def inception_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Inception tree (`ucdir_tpu/metrics/inception.py`:
    nested dicts of numpy arrays, each BasicConv's conv/kernel HWIO,
    bn_scale, bn_bias, and fc/kernel (2048, 1000), fc/bias where the head is
    there) -> the port's state dict (`ucdir_tpu_torch/metrics/inception.py`:
    <path>.conv.weight OIHW, <path>.bn_scale, <path>.bn_bias, fc.weight
    (1000, 2048), fc.bias), float32."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            name = '.'.join(path)
            if path == ('fc',):
                v = _dense(v) if k == 'kernel' else v
                out['fc.' + ('weight' if k == 'kernel' else k)] = v
            elif k == 'kernel':
                out[name + '.weight'] = _conv(v)
            else:
                out[name + '.' + k] = v
    walk(params, ())
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}
