"""Host-side datasets (numpy HWC float32 in [-1, 1]). Counterpart of
`ucdir_tpu/data/datasets.py` (the port keeps its own copy).

Parity targets in data/LRHR_dataset.py:
  LRHRDataset           :133-227 (sr_N_M / hr_M / lr_N triplet dirs)
  PairDataset           :230-322 (lq/gt paired dirs, random crop, optional
                                  free-form mask, retry-on-error loop)
  SingleDataset         :325-379 (gt only, unconditional)
  ImagenetSRDataset     :385-443 (on-the-fly 64->256 bicubic SR pairs)
  ImagenetJPGDataset    :446-515 (center crop + cv2 JPEG at quality factor)
  ImagenetColorDataset  :518-558 (gray 3-channel input)

Storage: local filesystem ('img'/'mc') and 'lmdb' through the pure-Python
reader of lmdb_io.py (key schema: 'length', 'hr_{M}_{i:05d}',
'sr_{N}_{M}_{i:05d}', 'lr_{N}_{i:05d}', values = encoded image bytes).

PIL and cv2 are imported where an image is decoded, resized or encoded, so
importing this module needs neither.
"""
from __future__ import annotations

import os
import traceback

import numpy as np

from ucdir_tpu_torch.data import util as Util


class _Base:
    def __len__(self):
        return self.data_len

    def _resolve_len(self, n_items: int, data_len: int) -> int:
        return n_items if data_len is None or data_len <= 0 else min(data_len, n_items)


class LRHRDataset(_Base):
    def __init__(self, dataroot, datatype='img', l_resolution=16,
                 r_resolution=128, split='train', data_len=-1, need_LR=False,
                 **kwargs):
        self.split = split
        self.need_LR = need_LR
        self.l_res, self.r_res = l_resolution, r_resolution
        self.datatype = datatype
        if datatype == 'lmdb':
            # reference: lmdb.open(dataroot).get (LRHR_dataset.py:144-152)
            from ucdir_tpu_torch.data.lmdb_io import LmdbReader
            self.env = LmdbReader(dataroot)
            n = int(self.env.get('length'))
            self.data_len = self._resolve_len(n, data_len)
            return
        self.sr_path = Util.get_paths_from_images(
            '{}/sr_{}_{}'.format(dataroot, l_resolution, r_resolution))
        self.hr_path = Util.get_paths_from_images(
            '{}/hr_{}'.format(dataroot, r_resolution))
        if need_LR:
            self.lr_path = Util.get_paths_from_images(
                '{}/lr_{}'.format(dataroot, l_resolution))
        self.data_len = self._resolve_len(len(self.hr_path), data_len)

    def _lmdb_item(self, index):
        """Reference key schema + invalid-index resample loop
        (LRHR_dataset.py:191-206)."""
        import io
        import random
        from PIL import Image

        def fetch(i):
            hr = self.env.get('hr_{}_{}'.format(self.r_res, str(i).zfill(5)))
            sr = self.env.get('sr_{}_{}_{}'.format(self.l_res, self.r_res,
                                                   str(i).zfill(5)))
            lr = (self.env.get('lr_{}_{}'.format(self.l_res,
                                                 str(i).zfill(5)))
                  if self.need_LR else None)
            return hr, sr, lr

        hr, sr, lr = fetch(index)
        while hr is None or sr is None:
            hr, sr, lr = fetch(random.randint(0, self.data_len - 1))
        if self.need_LR and lr is None:
            # the reference's resample condition checks hr/sr only, so an
            # entry with hr/sr present but lr missing would reach
            # Image.open(None); fail with the missing key instead
            raise KeyError(
                'lmdb entry lr_{}_{:05d} missing while hr/sr are present — '
                'partially written lmdb env?'.format(self.l_res, index))
        return [np.asarray(Image.open(io.BytesIO(b)).convert('RGB'))
                for b in ((lr, sr, hr) if self.need_LR else (sr, hr))]

    def __getitem__(self, index):
        if self.datatype == 'lmdb':
            imgs = self._lmdb_item(index)
        elif self.need_LR:
            imgs = [Util.load_img(p[index]) for p in
                    (self.lr_path, self.sr_path, self.hr_path)]
        else:
            imgs = [Util.load_img(p[index]) for p in
                    (self.sr_path, self.hr_path)]
        if self.need_LR:
            img_LR, img_SR, img_HR = Util.transform_augment(
                imgs, split=self.split, min_max=(-1, 1))
            return {'LR': img_LR, 'HR': img_HR, 'SR': img_SR, 'Index': index}
        img_SR, img_HR = Util.transform_augment(
            imgs, split=self.split, min_max=(-1, 1))
        return {'HR': img_HR, 'SR': img_SR, 'Index': index}


class PairDataset(_Base):
    """lq/gt paired dirs; random crop at train; infinite retry on error.
    `datatype` is not read: both directories hold image files, as in the
    JAX package."""

    def __init__(self, dataroot, datatype='img', split='train', data_len=-1,
                 **kwargs):
        self.split = split
        self.crop_size = kwargs.get('crop_size', 0) or 0
        self.mask = kwargs.get('mask', -1) or -1
        # the reference hardwires free_form at the PairDataset call site
        # (LRHR_dataset.py:292) but its get_mask dispatches 5 modes (:304-322)
        self.mask_mode = kwargs.get('mask_mode') or 'free_form'
        self.sr_path = Util.get_paths_from_images(dataroot['lq'])
        self.hr_path = Util.get_paths_from_images(dataroot['gt'])
        self.data_len = self._resolve_len(len(self.hr_path), data_len)

    def __getitem__(self, index):
        while True:
            try:
                img_HR = Util.load_img(self.hr_path[index])
                img_SR = Util.load_img(self.sr_path[index])
                if self.crop_size > 0:
                    H, W = img_HR.shape[:2]
                    hs = np.random.randint(max(1, H - self.crop_size))
                    ws = np.random.randint(max(1, W - self.crop_size))
                    img_HR = img_HR[hs:hs + self.crop_size,
                                    ws:ws + self.crop_size]
                    img_SR = img_SR[hs:hs + self.crop_size,
                                    ws:ws + self.crop_size]
                img_SR, img_HR = Util.transform_augment(
                    [img_SR, img_HR], split=self.split, min_max=(-1, 1))

                mask = 0
                if self.mask > 0:
                    from ucdir_tpu_torch.data.mask import get_mask
                    mask = get_mask(self.mask_mode, img_SR.shape[:2])
                return {'HR': img_HR, 'SR': img_SR, 'Index': index,
                        'mask': mask}
            except Exception:
                print('**error', self.hr_path[index])
                print(traceback.format_exc())
                index = np.random.randint(self.data_len)


class SingleDataset(_Base):
    """gt-only (unconditional)."""

    def __init__(self, dataroot, datatype='img', split='train', data_len=-1,
                 **kwargs):
        self.split = split
        self.crop_size = kwargs.get('crop_size', 0) or 0
        self.hr_path = Util.get_paths_from_images(dataroot['gt'])
        self.data_len = self._resolve_len(len(self.hr_path), data_len)

    def __getitem__(self, index):
        while True:
            try:
                img_HR = Util.load_img(self.hr_path[index])
                if self.crop_size > 0:
                    H, W = img_HR.shape[:2]
                    hs = np.random.randint(max(1, H - self.crop_size))
                    ws = np.random.randint(max(1, W - self.crop_size))
                    img_HR = img_HR[hs:hs + self.crop_size,
                                    ws:ws + self.crop_size]
                (img_HR,) = Util.transform_augment([img_HR], split=self.split,
                                                   min_max=(-1, 1))
                return {'HR': img_HR, 'Index': index}
            except Exception:
                print('**error', self.hr_path[index])
                index = np.random.randint(self.data_len)


class _ImagenetTxtBase(_Base):
    def __init__(self, dataroot, datatype='img', split='train', data_len=-1,
                 **kwargs):
        self.split = split
        self.root = dataroot['root']
        with open(dataroot['txt'], 'r') as f:
            self.hr_path = [line.split(' ')[0].strip() for line in f]
        self.data_len = self._resolve_len(len(self.hr_path), data_len)
        self.sr_path = self.hr_path  # for result naming at test time

    def _load(self, index):
        """The image as an RGB PIL image."""
        from PIL import Image
        return Image.open(os.path.join(self.root,
                                       self.hr_path[index])).convert('RGB')


class ImagenetSRDataset(_ImagenetTxtBase):
    """64 -> 256 bicubic SR pairs built on the fly (LRHR_dataset.py:385-443)."""
    sizes = (64, 256)

    def __getitem__(self, index):
        from PIL import Image
        while True:
            try:
                img = self._load(index)
                lo, hi = self.sizes
                if min(img.size) < hi:
                    # torchvision-style resize: short side to `hi`
                    w, h = img.size
                    if w < h:
                        img = img.resize((hi, int(round(h * hi / w))),
                                         Image.BICUBIC)
                    else:
                        img = img.resize((int(round(w * hi / h)), hi),
                                         Image.BICUBIC)
                # center crop to square of the short side
                w, h = img.size
                s = min(w, h)
                left, top = (w - s) // 2, (h - s) // 2
                img_HR = img.crop((left, top, left + s, top + s))
                img_HR = img_HR.resize((hi, hi), Image.BICUBIC)
                img_LR = img_HR.resize((lo, lo), Image.BICUBIC)
                img_SR = img_LR.resize((hi, hi), Image.BICUBIC)

                img_SR, img_HR = Util.transform_augment(
                    [np.asarray(img_SR), np.asarray(img_HR)],
                    split=self.split, min_max=(-1, 1))
                return {'HR': img_HR, 'SR': img_SR, 'Index': index}
            except Exception:
                print('**error', self.hr_path[index])
                print(traceback.format_exc())
                index = np.random.randint(self.data_len)


class ImagenetJPGDataset(_ImagenetTxtBase):
    """JPEG restoration pairs: center crop (or /16 crop) + cv2 JPEG encode at
    quality `factor` (LRHR_dataset.py:446-515; val factor [10,10] is forced by
    config.parse's jpg- branch). Without cv2 an item raises ImportError: no
    other codec stands in for it."""

    def __init__(self, dataroot, datatype='img', split='train', data_len=-1,
                 **kwargs):
        super().__init__(dataroot, datatype, split, data_len, **kwargs)
        self.crop_size = kwargs.get('crop_size', 0) or 0
        self.factor = kwargs.get('factor', [5, 5])

    def _crop_hr(self, img):
        if 0 < self.crop_size and min(img.size) < self.crop_size:
            img = img.resize((self.crop_size, self.crop_size))
        w, h = img.size
        if self.crop_size > 0:
            ws, hs = (w - self.crop_size) // 2, (h - self.crop_size) // 2
            return img.crop((ws, hs, ws + self.crop_size, hs + self.crop_size))
        # crop to a /16-divisible size (full-image val)
        tw, th = w // 16 * 16, h // 16 * 16
        ws, hs = (w - tw) // 2, (h - th) // 2
        return img.crop((ws, hs, ws + tw, hs + th))

    def _degrade(self, img_HR: np.ndarray) -> np.ndarray:
        import cv2
        q = self.factor[0] if self.factor[0] == self.factor[1] else \
            np.random.randint(self.factor[0], self.factor[1] + 1)
        _, enc = cv2.imencode('.jpg', img_HR,
                              [int(cv2.IMWRITE_JPEG_QUALITY), int(q)])
        return cv2.imdecode(enc, 3)

    def __getitem__(self, index):
        while True:
            try:
                img_HR = np.asarray(self._crop_hr(self._load(index)))
                img_SR = self._degrade(img_HR)
                img_SR, img_HR = Util.transform_augment(
                    [img_SR, img_HR], split=self.split, min_max=(-1, 1))
                return {'HR': img_HR, 'SR': img_SR, 'Index': index}
            except ImportError:
                raise       # a missing decoder is no bad file to skip
            except Exception:
                print('**error', self.hr_path[index])
                print(traceback.format_exc())
                index = np.random.randint(self.data_len)


class ImagenetColorDataset(ImagenetJPGDataset):
    """Colorization: input = 3-channel gray mean (LRHR_dataset.py:518-558)."""

    def _degrade(self, img_HR: np.ndarray) -> np.ndarray:
        gray = img_HR.astype(np.float32).mean(axis=-1, keepdims=True)
        return np.repeat(gray, 3, axis=-1).astype(np.uint8)
