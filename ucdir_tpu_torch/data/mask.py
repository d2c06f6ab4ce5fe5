"""Free-form / bbox / irregular mask generators (host side, numpy + PIL).
Counterpart of `ucdir_tpu/data/mask.py` (the port keeps its own copy; PIL is
imported where a stroke is drawn).

Behavioral equivalents of data/mask.py (random_bbox :35-95,
bbox2mask :97-117, brush_stroke_mask :119-217, random_irregular_mask /
get_irregular_mask :219-328) — same mask families and statistics, fresh
implementation. Masks are uint8 HW1 with 1 = hole.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def random_bbox(img_shape: Tuple[int, int] = (256, 256),
                max_bbox_shape: Tuple[int, int] = (128, 128),
                max_bbox_delta: int = 40, min_margin: int = 20,
                rng=np.random):
    """Returns (top, left, h, w) of a random box with margins."""
    img_h, img_w = img_shape[:2]
    max_h, max_w = max_bbox_shape
    max_h = min(max_h, img_h - 2 * min_margin)
    max_w = min(max_w, img_w - 2 * min_margin)
    delta = min(max_bbox_delta, max_h - 1, max_w - 1)
    h = max_h - rng.randint(max(1, delta))
    w = max_w - rng.randint(max(1, delta))
    top = rng.randint(min_margin, max(min_margin + 1, img_h - h - min_margin))
    left = rng.randint(min_margin, max(min_margin + 1, img_w - w - min_margin))
    return (top, left, h, w)


def bbox2mask(img_shape: Tuple[int, int], bbox, dtype='uint8') -> np.ndarray:
    mask = np.zeros(tuple(img_shape[:2]) + (1,), dtype=dtype)
    top, left, h, w = bbox
    mask[top:top + h, left:left + w, :] = 1
    return mask


def brush_stroke_mask(img_shape: Tuple[int, int] = (256, 256),
                      min_num_vertex: int = 4, max_num_vertex: int = 12,
                      mean_angle: float = 2 * math.pi / 5,
                      angle_range: float = 2 * math.pi / 15,
                      min_width: int = 12, max_width: int = 40,
                      rng=np.random) -> np.ndarray:
    """DeepFill-v2 style free-form brush strokes (the reference's
    `free_form` mode used by PairDataset, LRHR_dataset.py:312-313)."""
    from PIL import Image, ImageDraw
    H, W = img_shape[:2]
    average_radius = math.sqrt(H * H + W * W) / 8
    mask = Image.new('L', (W, H), 0)
    draw = ImageDraw.Draw(mask)

    for _ in range(rng.randint(1, 4)):
        num_vertex = rng.randint(min_num_vertex, max_num_vertex)
        angle_min = mean_angle - rng.uniform(0, angle_range)
        angle_max = mean_angle + rng.uniform(0, angle_range)
        angles = []
        for i in range(num_vertex):
            a = rng.uniform(angle_min, angle_max)
            angles.append(2 * math.pi - a if i % 2 == 0 else a)

        vertex = [(int(rng.randint(0, W)), int(rng.randint(0, H)))]
        for a in angles:
            r = np.clip(rng.normal(loc=average_radius, scale=average_radius // 2),
                        0, 2 * average_radius)
            x = np.clip(vertex[-1][0] + r * math.cos(a), 0, W)
            y = np.clip(vertex[-1][1] + r * math.sin(a), 0, H)
            vertex.append((int(x), int(y)))

        width = int(rng.uniform(min_width, max_width))
        draw.line(vertex, fill=1, width=width)
        for v in vertex:
            draw.ellipse((v[0] - width // 2, v[1] - width // 2,
                          v[0] + width // 2, v[1] + width // 2), fill=1)

    if rng.random() < 0.5:
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    if rng.random() < 0.5:
        mask = mask.transpose(Image.FLIP_TOP_BOTTOM)
    return np.asarray(mask, np.uint8)[:, :, None]


def random_irregular_mask(img_shape: Tuple[int, int], num_vertex=(4, 8),
                          max_angle: float = 4.0, length_range=(10, 100),
                          brush_width=(10, 40), rng=np.random) -> np.ndarray:
    """Random walk strokes (reference :219-299 family)."""
    from PIL import Image, ImageDraw
    H, W = img_shape[:2]
    mask = np.zeros((H, W), np.uint8)
    n = rng.randint(num_vertex[0], num_vertex[1])
    img = Image.fromarray(mask)
    draw = ImageDraw.Draw(img)
    x, y = rng.randint(W), rng.randint(H)
    for _ in range(n):
        angle = rng.uniform(0, max_angle)
        length = rng.randint(length_range[0], length_range[1])
        w = rng.randint(brush_width[0], brush_width[1])
        nx = int(np.clip(x + length * math.cos(angle), 0, W))
        ny = int(np.clip(y + length * math.sin(angle), 0, H))
        draw.line([(x, y), (nx, ny)], fill=1, width=w)
        x, y = nx, ny
    return np.asarray(img, np.uint8)[:, :, None]


def get_irregular_mask(img_shape: Tuple[int, int],
                       area_ratio_range=(0.15, 0.5), rng=np.random,
                       max_tries: int = 20) -> np.ndarray:
    """Resample until the hole area ratio lands in range (reference :301-328)."""
    mask = random_irregular_mask(img_shape, rng=rng)
    lo, hi = area_ratio_range
    for _ in range(max_tries):
        ratio = float(mask.mean())
        if lo <= ratio <= hi:
            break
        mask = random_irregular_mask(img_shape, rng=rng)
    return mask


def get_mask(mask_mode: str, image_size: Tuple[int, int],
             rng=np.random) -> np.ndarray:
    """Mode dispatch mirroring MemcachedBase.get_mask
    (data/LRHR_dataset.py:304-322). Returns uint8 HW1,
    1 = hole."""
    if mask_mode == 'bbox':
        return bbox2mask(image_size, random_bbox(image_size, rng=rng))
    if mask_mode == 'center':
        h, w = image_size[:2]
        return bbox2mask(image_size, (h // 4, w // 4, h // 2, w // 2))
    if mask_mode == 'irregular':
        return get_irregular_mask(image_size, rng=rng)
    if mask_mode == 'free_form':
        return brush_stroke_mask(image_size, rng=rng)
    if mask_mode == 'hybrid':
        regular = bbox2mask(image_size, random_bbox(image_size, rng=rng))
        irregular = brush_stroke_mask(image_size, rng=rng)
        return (regular | irregular).astype(np.uint8)
    raise NotImplementedError(
        'Mask mode {} has not been implemented.'.format(mask_mode))
