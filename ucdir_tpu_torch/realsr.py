"""Real-ESRGAN-style degradation training: dataset + trainer. Counterpart of
`ucdir_tpu/realsr.py`.

Parity targets:
  * RealESRGANDataset — data/LRHR_dataset.py:668-807 (per-item blur/sinc
    kernel synthesis with the `param`/`param1` presets :638-665), on the host;
  * TrainerRealSR (DDPM_realsr) — model/model.py:395-577: the two-stage
    degradation feed (USM sharpen -> blur -> random resize -> noise ->
    DiffJPEG -> second stage -> [resize+sinc, JPEG] order coin-flip ->
    clamp/round -> paired random crop -> training-pair queue -> x4 upscale ->
    [-1,1]) on the trainer's device, from the loader's batch to the train
    step's, with no copy back to the host.

Draws: the per-step coins (resize direction, scale and mode, noise kind,
the order of the last stage, the crop, the queue's permutation) come from
Python's `random` and `np.random` in the JAX package's order, so the same
seeds give the same coins in both packages. The per-sample draws (noise
sigma or scale, gray, the noise itself, the Poisson counts, the JPEG
quality) come from the trainer's own torch.Generator on its device, seeded
from its seed and its rank (each rank degrades its own shard, as in the JAX
package); `feed_data(data, draws=...)` can inject them instead.

Hard rounding: the last `clip(round(out * 255)) / 255` is discontinuous; a
sum in another order than the host's or the JAX package's moves a value by
one 1/255 level where it lies within float error of a half level. On the
card the feed's convolutions and matmuls need TF32 off, as sr.py sets it.
"""
from __future__ import annotations

import math
import os
import random
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ucdir_tpu_torch.data import util as Util
from ucdir_tpu_torch.data.datasets import ImagenetJPGDataset
from ucdir_tpu_torch.data.degradations import (circular_lowpass_kernel,
                                               random_mixed_kernels, filter2D,
                                               usm_sharp, interpolate,
                                               gaussian_noise_draws,
                                               poisson_noise_draws,
                                               random_add_gaussian_noise_pt,
                                               random_add_poisson_noise_pt)
from ucdir_tpu_torch.data.diffjpeg import diff_jpeg
from ucdir_tpu_torch.trainer import Trainer, local_seed

# degradation presets (reference LRHR_dataset.py:638-665)
param = {
    'blur_kernel_size': 21,
    'kernel_list': ['iso', 'aniso', 'generalized_iso', 'generalized_aniso',
                    'plateau_iso', 'plateau_aniso'],
    'kernel_prob': [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    'sinc_prob': 0.1, 'blur_sigma': [0.2, 3],
    'betag_range': [0.5, 4], 'betap_range': [1, 2],
    'blur_kernel_size2': 21,
    'kernel_list2': ['iso', 'aniso', 'generalized_iso', 'generalized_aniso',
                     'plateau_iso', 'plateau_aniso'],
    'kernel_prob2': [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    'sinc_prob2': 0.1, 'blur_sigma2': [0.2, 1.5],
    'betag_range2': [0.5, 4], 'betap_range2': [1, 2],
    'final_sinc_prob': 0.8,
    'use_hflip': True, 'use_rot': False,
}
param1 = dict(param)
param1.update({
    'blur_sigma': [0.2, 1.5], 'betag_range': [0.5, 2.0], 'betap_range': [1, 1.5],
    'blur_kernel_size2': 11, 'blur_sigma2': [0.2, 1.0],
    'betag_range2': [0.5, 2.0], 'betap_range2': [1, 1.5],
})

# degradation-pipeline presets (reference model/model.py:339-392)
dopt = {
    'scale': 4, 'resize_prob': [0.2, 0.7, 0.1], 'resize_range': [0.15, 1.5],
    'gaussian_noise_prob': 0.5, 'noise_range': [1, 30],
    'poisson_scale_range': [0.05, 3], 'gray_noise_prob': 0.4,
    'jpeg_range': [30, 95],
    'second_blur_prob': 0.8, 'resize_prob2': [0.3, 0.4, 0.3],
    'resize_range2': [0.3, 1.2], 'gaussian_noise_prob2': 0.5,
    'noise_range2': [1, 25], 'poisson_scale_range2': [0.05, 2.5],
    'gray_noise_prob2': 0.4, 'jpeg_range2': [30, 95],
    'gt_size': 256, 'queue_size': 180,
}
dopt1 = {
    'scale': 4, 'resize_prob': [0.2, 0.7, 0.1], 'resize_range': [0.3, 1.5],
    'gaussian_noise_prob': 0.5, 'noise_range': [1, 15],
    'poisson_scale_range': [0.05, 2.0], 'gray_noise_prob': 0.4,
    'jpeg_range': [60, 95],
    'second_blur_prob': 0.5, 'resize_prob2': [0.3, 0.4, 0.3],
    'resize_range2': [0.6, 1.2], 'gaussian_noise_prob2': 0.5,
    'noise_range2': [1, 12], 'poisson_scale_range2': [0.05, 1.0],
    'gray_noise_prob2': 0.4, 'jpeg_range2': [60, 100],
    'gt_size': 256, 'queue_size': 180,
}
dopt1gt = dict(dopt1)
dopt1gt.update({'gt_size': 256 + 128, 'queue_size': 181})

DOPTS = {'dopt': dopt, 'dopt1': dopt1, 'dopt1gt': dopt1gt}
PARAMS = {'param': param, 'param1': param1}

_KERNEL_RANGE = [2 * v + 1 for v in range(3, 11)]  # 7..21

# The feed limit: how far two runs of the feed on the same coins and draws
# (on two devices, or the port and the JAX package) may differ, on the
# feed's own [0, 1] scale. HR within 1e-4 (USM's threshold mask is a step
# function); SR, the x4 upscale of the rounded LQ, within 1e-3 mean abs and
# at least 99% of its values on the same 1/255 level (within half a level).
FEED_LIMIT = {'hr_max_abs': 1e-4, 'sr_mean_abs': 1e-3, 'sr_same_level': 0.99}


def feed_agreement(got, want):
    """{'hr_max_abs', 'sr_mean_abs', 'sr_same_level', 'sr_max_abs', 'ok'}
    of two feeds' data ({'SR', 'HR'} in [-1, 1], arrays or tensors): the
    differences on [0, 1] and whether they hold FEED_LIMIT."""
    def diff(k):
        a, b = (v.detach().cpu().double() if torch.is_tensor(v)
                else torch.tensor(np.asarray(v), dtype=torch.float64)
                for v in (got[k], want[k]))
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise ValueError('%s: shapes %s and %s, or non-finite values'
                             % (k, tuple(a.shape), tuple(b.shape)))
        return (a - b).abs() / 2
    hr, sr = diff('HR'), diff('SR')
    out = {'hr_max_abs': hr.max().item(), 'sr_mean_abs': sr.mean().item(),
           'sr_same_level': (sr < 0.5 / 255).double().mean().item(),
           'sr_max_abs': sr.max().item()}
    out['ok'] = (out['hr_max_abs'] <= FEED_LIMIT['hr_max_abs']
                 and out['sr_mean_abs'] <= FEED_LIMIT['sr_mean_abs']
                 and out['sr_same_level'] >= FEED_LIMIT['sr_same_level'])
    return out


class RealESRGANDataset(ImagenetJPGDataset):
    """gt + per-item random blur/sinc kernels (RGB HWC [0,1] here)."""

    def __init__(self, dataroot, datatype='img', split='train', data_len=-1,
                 **kwargs):
        super().__init__(dataroot, datatype, split, data_len, **kwargs)
        self.opt = PARAMS[kwargs.get('param', 'param')]
        self.pulse = np.zeros((21, 21), np.float32)
        self.pulse[10, 10] = 1.

    def _random_kernel(self, sinc_prob, kernel_list, kernel_prob, blur_sigma,
                       betag_range, betap_range):
        kernel_size = random.choice(_KERNEL_RANGE)
        if np.random.uniform() < sinc_prob:
            omega_c = np.random.uniform(
                np.pi / 3 if kernel_size < 13 else np.pi / 5, np.pi)
            kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=False)
        else:
            kernel = random_mixed_kernels(
                kernel_list, kernel_prob, kernel_size, blur_sigma, blur_sigma,
                [-math.pi, math.pi], betag_range, betap_range, noise_range=None)
        pad = (21 - kernel_size) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)

    def __getitem__(self, index):
        img_gt = Util.to_float(Util.load_img(
            os.path.join(self.root, self.hr_path[index])))
        return self.from_image(img_gt, index)

    def from_image(self, img_gt: np.ndarray, index: int) -> Dict[str, Any]:
        """The item of a loaded image (HWC float32 in [0, 1]): the flips,
        the crop or reflect pad to crop_size, and the three kernels."""
        if self.split == 'train':
            if self.opt['use_hflip'] and random.random() < 0.5:
                img_gt = np.ascontiguousarray(img_gt[:, ::-1])
            if self.opt['use_rot'] and random.random() < 0.5:
                img_gt = np.ascontiguousarray(img_gt.transpose(1, 0, 2))
        elif self.split != 'val':
            return {'lq': img_gt, 'gt': img_gt, 'Index': index}

        # crop or reflect-pad to crop_size (reference :743-758)
        cps = self.crop_size
        h, w = img_gt.shape[:2]
        if h < cps or w < cps:
            img_gt = np.pad(img_gt, ((0, max(0, cps - h)), (0, max(0, cps - w)),
                                     (0, 0)), mode='reflect')
        h, w = img_gt.shape[:2]
        if h > cps or w > cps:
            top = random.randint(0, h - cps)
            left = random.randint(0, w - cps)
            img_gt = img_gt[top:top + cps, left:left + cps]

        o = self.opt
        kernel1 = self._random_kernel(o['sinc_prob'], o['kernel_list'],
                                      o['kernel_prob'], o['blur_sigma'],
                                      o['betag_range'], o['betap_range'])
        kernel2 = self._random_kernel(o['sinc_prob2'], o['kernel_list2'],
                                      o['kernel_prob2'], o['blur_sigma2'],
                                      o['betag_range2'], o['betap_range2'])
        if np.random.uniform() < o['final_sinc_prob']:
            ks = random.choice(_KERNEL_RANGE)
            sinc = circular_lowpass_kernel(
                np.random.uniform(np.pi / 3, np.pi), ks,
                pad_to=21).astype(np.float32)
        else:
            sinc = self.pulse

        return {'gt': img_gt, 'kernel1': kernel1, 'kernel2': kernel2,
                'sinc_kernel': sinc, 'Index': index}


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale):
    """Random aligned crop of NHWC tensors (reference model/model.py:291-336);
    the offset from Python's `random`."""
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    if single_gt:
        img_gts = [img_gts]
    if single_lq:
        img_lqs = [img_lqs]
    h_lq, w_lq = img_lqs[0].shape[1:3]
    lq_ps = gt_patch_size // scale
    top = random.randint(0, h_lq - lq_ps)
    left = random.randint(0, w_lq - lq_ps)
    img_lqs = [v[:, top:top + lq_ps, left:left + lq_ps] for v in img_lqs]
    tg, lg = top * scale, left * scale
    img_gts = [v[:, tg:tg + gt_patch_size, lg:lg + gt_patch_size]
               for v in img_gts]
    if single_gt:
        img_gts = img_gts[0]
    if single_lq:
        img_lqs = img_lqs[0]
    return img_gts, img_lqs


# draws(name, img, make) -> the draws of one per-sample draw site: `make()`
# draws them from the trainer's generator; a test returns its own instead.
# Sites: 'gaussian1' or 'poisson1' (the `_pt` function's dict), 'jpeg1'
# ({'quality': (b,)}), and the same with 2 for the second stage.
Draws = Callable[[str, torch.Tensor, Callable[[], Dict[str, torch.Tensor]]],
                 Dict[str, torch.Tensor]]


class TrainerRealSR(Trainer):
    """DDPM_realsr: the two-stage degradation feed on the trainer's device.
    opt['dopt'] names the preset (DOPTS), opt['queue_size'] overrides its
    queue, opt['gt_usm'] (default true) trains on the sharpened gt."""

    def __init__(self, opt, device, seed: int = 0):
        super().__init__(opt, device, seed)
        self.dopt = DOPTS[opt.get('dopt', 'dopt')]
        self.queue_size = opt.get('queue_size') or self.dopt['queue_size']
        self.queue_lr = None
        self.queue_gt = None
        self.queue_ptr = 0
        self.is_train = opt['phase'] == 'train'
        self.gt_usm_for_hr = opt.get('gt_usm', True)
        if self.gt_usm_for_hr is None:
            self.gt_usm_for_hr = True
        self.feed_generator = torch.Generator(self.device).manual_seed(
            local_seed(seed + 3, self.rank))

    def _dequeue_and_enqueue(self, lq, gt):
        """Training-pair pool (reference model.py:405-444) on the device;
        the swap's permutation from np.random."""
        b = lq.shape[0]
        if self.queue_lr is None:
            if self.queue_size % b:
                raise ValueError('queue_size %d is not a multiple of the '
                                 'batch %d' % (self.queue_size, b))
            self.queue_lr = lq.new_zeros((self.queue_size,) + lq.shape[1:])
            self.queue_gt = gt.new_zeros((self.queue_size,) + gt.shape[1:])
            self.queue_ptr = 0
        if self.queue_ptr == self.queue_size:
            idx = torch.from_numpy(np.random.permutation(self.queue_size)).to(
                lq.device)
            self.queue_lr = self.queue_lr[idx]
            self.queue_gt = self.queue_gt[idx]
            lq_out = self.queue_lr[:b].clone()
            gt_out = self.queue_gt[:b].clone()
            self.queue_lr[:b] = lq
            self.queue_gt[:b] = gt
            return lq_out, gt_out
        n = min(b, self.queue_size - self.queue_ptr)
        self.queue_lr[self.queue_ptr:self.queue_ptr + n] = lq[:n]
        self.queue_gt[self.queue_ptr:self.queue_ptr + n] = gt[:n]
        self.queue_ptr += n
        return lq, gt

    def _stage(self, key, stage):
        """The dopt value of `key` for degradation stage 1 or 2."""
        return self.dopt[key + ('' if stage == 1 else '2')]

    def _resize_coin(self, stage):
        updown = random.choices(['up', 'down', 'keep'],
                                self._stage('resize_prob', stage))[0]
        lo, hi = self._stage('resize_range', stage)
        if updown == 'up':
            return np.random.uniform(1, hi)
        if updown == 'down':
            return np.random.uniform(lo, 1)
        return 1

    def _noise(self, stage, img, draws):
        """The stage's noise, gaussian or poisson by a np.random coin."""
        gray_prob = self._stage('gray_noise_prob', stage)
        gen = self.feed_generator
        if np.random.uniform() < self._stage('gaussian_noise_prob', stage):
            sigma = self._stage('noise_range', stage)
            return random_add_gaussian_noise_pt(
                img, sigma_range=sigma, gray_prob=gray_prob, clip=True,
                rounds=False, draws=draws(
                    'gaussian%d' % stage, img,
                    lambda: gaussian_noise_draws(img, sigma, gen)))
        scale = self._stage('poisson_scale_range', stage)
        return random_add_poisson_noise_pt(
            img, scale_range=scale, gray_prob=gray_prob, clip=True,
            rounds=False, draws=draws(
                'poisson%d' % stage, img,
                lambda: poisson_noise_draws(img, scale, gen)))

    def _jpeg(self, stage, img, draws):
        """Hard DiffJPEG at a per-sample quality in the stage's range."""
        lo, hi = self._stage('jpeg_range', stage)

        def make():
            return {'quality': torch.rand(
                (img.shape[0],), generator=self.feed_generator,
                device=img.device) * (hi - lo) + lo}
        q = draws('jpeg%d' % stage, img, make)['quality']
        return diff_jpeg(torch.clamp(img, 0, 1), q, differentiable=False)

    def feed_data(self, data: Dict[str, Any], draws: Optional[Draws] = None):
        """self.data = {'SR', 'HR'}: NHWC float32 tensors in [-1, 1] on the
        trainer's device. In the train phase `data` is a batch of
        RealESRGANDataset items ('gt', 'kernel1', 'kernel2', 'sinc_kernel')
        and SR the x4 upscale of its degradation; else 'lq' (and 'gt')."""
        d = self.dopt
        draws = draws or (lambda name, img, make: make())
        if not self.is_train:
            lq = self.to_device(data['lq'])
            gt = self.to_device(data.get('gt', data['lq']))
            gt_usm = usm_sharp(gt, radius=15)
            hr = gt_usm if self.gt_usm_for_hr else gt
            self.data = {'SR': lq * 2. - 1., 'HR': hr * 2. - 1.}
            return

        gt = self.to_device(data['gt'])                    # (b,h,w,3) [0,1]
        kernel1 = self.to_device(data['kernel1'])          # (b,21,21)
        kernel2 = self.to_device(data['kernel2'])
        sinc_kernel = self.to_device(data['sinc_kernel'])
        ori_h, ori_w = gt.shape[1:3]

        gt_usm = usm_sharp(gt, radius=15)

        # ---------------- first degradation (model.py:461-489) --------------
        out = filter2D(gt_usm, kernel1)
        scale = self._resize_coin(1)
        mode = random.choice(['area', 'bilinear', 'bicubic'])
        out = interpolate(out, scale_factor=scale, mode=mode)
        out = self._noise(1, out, draws)
        out = self._jpeg(1, out, draws)

        # ---------------- second degradation (model.py:491-543) -------------
        if np.random.uniform() < d['second_blur_prob']:
            out = filter2D(out, kernel2)
        scale = self._resize_coin(2)
        mode = random.choice(['area', 'bilinear', 'bicubic'])
        out = interpolate(out, size=(int(ori_h / d['scale'] * scale),
                                     int(ori_w / d['scale'] * scale)),
                          mode=mode)
        out = self._noise(2, out, draws)

        final_size = (ori_h // d['scale'], ori_w // d['scale'])
        if np.random.uniform() < 0.5:
            mode = random.choice(['area', 'bilinear', 'bicubic'])
            out = interpolate(out, size=final_size, mode=mode)
            out = filter2D(out, sinc_kernel)
            out = self._jpeg(2, out, draws)
        else:
            out = self._jpeg(2, out, draws)
            mode = random.choice(['area', 'bilinear', 'bicubic'])
            out = interpolate(out, size=final_size, mode=mode)
            out = filter2D(out, sinc_kernel)

        lq = torch.clamp(torch.round(out * 255.0), 0, 255) / 255.

        # random crop + pair queue + final x4 upscale (model.py:546-575)
        (gt, gt_usm), lq = paired_random_crop([gt, gt_usm], lq, d['gt_size'],
                                              d['scale'])
        lq, gt = self._dequeue_and_enqueue(lq, gt)
        gt_usm = usm_sharp(gt, radius=15)  # re-sharpen dequeued gt
        lq = interpolate(lq, scale_factor=d['scale'], mode='bilinear')

        hr = gt_usm if self.gt_usm_for_hr else gt
        self.data = {'SR': lq * 2. - 1., 'HR': hr * 2. - 1.}
