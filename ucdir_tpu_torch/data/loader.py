"""Dataset factory + threaded prefetching loader (host side). Counterpart of
`ucdir_tpu/data/loader.py` (the port keeps its own copy).

`create_dataset` mirrors data/__init__.py:55-75 (string
dispatch on `datasetname` + `data_args`, RealESRGANDataset from realsr.py,
user-registered names through DATASET_REGISTRY, LRHRDataset fallback).
`create_dataloader` mirrors :24-52: train = sharded sampler + drop_last,
val = batch `val_batch` (1, the reference's, unless sr.py's --val_batch
sets it; the images of one batch must share one size), also sharded (each
rank scores its shard, padded to a multiple of the world size with repeated
indices, as EnlargedSampler pads).

The loader prefetches with a thread pool (PIL/cv2 release the GIL) and yields
dict-of-numpy batches; the trainer copies them to the card through pinned
memory.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np

from ucdir_tpu_torch.data.sampler import EnlargedSampler
from ucdir_tpu_torch.data import datasets as _datasets


def create_dataset(dataset_opt: Dict[str, Any], phase: str):
    if dataset_opt.get('datasetname'):
        name = dataset_opt['datasetname']
        if hasattr(_datasets, name):
            cls = getattr(_datasets, name)
        elif name == 'RealESRGANDataset':
            from ucdir_tpu_torch.realsr import RealESRGANDataset as cls
        else:
            from ucdir_tpu_torch.utils.registry import DATASET_REGISTRY
            cls = DATASET_REGISTRY.get(name)  # user-registered datasets
        dataset = cls(**dict(dataset_opt['data_args']))
    else:
        dataset = _datasets.LRHRDataset(
            dataroot=dataset_opt['dataroot'],
            datatype=dataset_opt.get('datatype', 'img'),
            l_resolution=dataset_opt.get('l_resolution', 16),
            r_resolution=dataset_opt.get('r_resolution', 128),
            split=phase,
            data_len=dataset_opt.get('data_len', -1) or -1,
            need_LR=(dataset_opt.get('mode') == 'LRHR'))
    logging.getLogger('base').info(
        'Dataset [%s - %s] is created.', type(dataset).__name__,
        dataset_opt.get('name'))
    return dataset


def _collate(items):
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if np.isscalar(vals[0]):
            out[k] = np.asarray(vals)
        else:
            vals = [np.asarray(v) for v in vals]
            shapes = sorted({v.shape for v in vals})
            if len(shapes) > 1:
                raise ValueError('a batch of %r needs items of one size, got '
                                 '%s (--val_batch > 1 needs same-size '
                                 'validation images)' % (k, shapes))
            out[k] = np.stack(vals, axis=0)
    return out


class DataLoader:
    """Order-preserving threaded prefetch loader.

    One epoch per iteration pass; call `set_epoch` between epochs for the
    deterministic reshuffle (reference re-creates iterators per epoch).
    """

    def __init__(self, dataset, batch_size: int, sampler: EnlargedSampler,
                 num_workers: int = 1, drop_last: bool = False,
                 prefetch_batches: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, int(num_workers or 1))
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = list(self.sampler)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(batches)

            def submit_next():
                try:
                    b = next(it)
                except StopIteration:
                    return False
                pending.append(pool.submit(
                    lambda idxs: _collate([self.dataset[i] for i in idxs]), b))
                return True

            for _ in range(self.prefetch_batches):
                if not submit_next():
                    break
            while pending:
                fut = pending.pop(0)
                submit_next()
                yield fut.result()


def create_dataloader(dataset, dataset_opt: Dict[str, Any], phase: str,
                      rank: int = 0, world_size: int = 1,
                      sample_ratio: int = 1, seed: int = 0) -> DataLoader:
    sampler = EnlargedSampler(dataset, world_size, rank, sample_ratio, seed)
    if phase == 'train':
        return DataLoader(dataset, batch_size=dataset_opt['batch_size'],
                          sampler=sampler,
                          num_workers=dataset_opt.get('num_workers', 1),
                          drop_last=True)
    if phase == 'val':
        # reference val is batch 1 (data/__init__.py:46-49); sr.py's
        # --val_batch sets val_batch
        return DataLoader(dataset,
                          batch_size=int(dataset_opt.get('val_batch') or 1),
                          sampler=sampler, num_workers=1, drop_last=False)
    raise NotImplementedError('Dataloader [{:s}] is not found.'.format(phase))
