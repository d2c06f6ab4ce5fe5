"""Image IO + augmentation (host side, numpy HWC). Counterpart of
`ucdir_tpu/data/util.py` (the port keeps its own copy).

Parity targets in data/util.py:
  get_paths_from_images  util.py:15-24 (recursive sorted walk, extension list)
  transform_augment      util.py:74-83 (ToTensor /255 + paired random hflip on
                         train + affine to [min_max]); output here is HWC
                         float32 (NHWC batches) instead of CHW tensors.
"""
from __future__ import annotations

import os
import random
from typing import List, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = ('.jpg', '.JPG', '.jpeg', '.JPEG',
                  '.png', '.PNG', '.ppm', '.PPM', '.bmp', '.BMP')


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def get_paths_from_images(path: str) -> List[str]:
    assert os.path.isdir(path), '{:s} is not a valid directory'.format(path)
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    assert images, '{:s} has no valid image file'.format(path)
    return sorted(images)


def load_img(path: str) -> np.ndarray:
    """PIL load -> uint8 HWC RGB."""
    from PIL import Image
    return np.asarray(Image.open(path).convert('RGB'))


def to_float(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0,1] (torchvision ToTensor equivalent,
    minus the CHW transpose)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img.astype(np.float32) / 255.


def transform_augment(img_list: Sequence[np.ndarray], split: str = 'val',
                      min_max: Tuple[float, float] = (0, 1),
                      rng: random.Random = random) -> List[np.ndarray]:
    """Paired augmentation: one horizontal-flip coin per *sample* applied to
    all images in the list (reference stacks then flips, util.py:76-83)."""
    imgs = [to_float(im) for im in img_list]
    if split == 'train' and rng.random() < 0.5:
        imgs = [np.ascontiguousarray(im[:, ::-1, :]) for im in imgs]
    lo, hi = min_max
    return [im * (hi - lo) + lo for im in imgs]
