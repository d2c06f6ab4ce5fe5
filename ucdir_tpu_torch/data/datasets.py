"""Host-side datasets (numpy HWC float32 in [-1, 1]). Counterpart of
`ucdir_tpu/data/datasets.py`; the port keeps its own copy of the dataset the
SID configuration uses:

  PairDataset   lq/gt paired dirs, random crop at train, retry-on-error loop
                (reference data/LRHR_dataset.py:230-322)

The other dataset kinds of the JAX package (LRHRDataset and its lmdb
storage, SingleDataset, the Imagenet SR/JPG/Color sets, the free-form masks)
are not ported yet: `create_dataset` raises for them (ROADMAP.md).
"""
from __future__ import annotations

import traceback

import numpy as np

from ucdir_tpu_torch.data import util as Util

NOT_PORTED = ('LRHRDataset', 'SingleDataset', 'ImagenetSRDataset',
              'ImagenetJPGDataset', 'ImagenetColorDataset',
              'RealESRGANDataset')


class PairDataset:
    """lq/gt paired dirs; random crop at train; infinite retry on error."""

    def __init__(self, dataroot, datatype='img', split='train', data_len=-1,
                 **kwargs):
        if datatype == 'lmdb':
            raise NotImplementedError('lmdb storage is not ported yet; see '
                                      'ROADMAP.md')
        if (kwargs.get('mask', -1) or -1) > 0:
            raise NotImplementedError('PairDataset masks are not ported yet; '
                                      'see ROADMAP.md')
        self.split = split
        self.crop_size = kwargs.get('crop_size', 0) or 0
        self.sr_path = Util.get_paths_from_images(dataroot['lq'])
        self.hr_path = Util.get_paths_from_images(dataroot['gt'])
        n = len(self.hr_path)
        self.data_len = (n if data_len is None or data_len <= 0
                         else min(data_len, n))

    def __len__(self):
        return self.data_len

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
                return {'HR': img_HR, 'SR': img_SR, 'Index': index, 'mask': 0}
            except Exception:
                print('**error', self.hr_path[index])
                print(traceback.format_exc())
                index = np.random.randint(self.data_len)
