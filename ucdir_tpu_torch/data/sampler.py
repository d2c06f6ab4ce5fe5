"""Counterpart of `ucdir_tpu/data/sampler.py` (the port keeps its own copy).

EnlargedSampler — deterministic per-epoch shuffled, rank-strided indices.

Parity target: data/data_sampler.py:9-55. Supports an
enlarging ratio for iteration-based training; indices wrap modulo dataset
length. Shuffle uses numpy's PCG instead of torch's Philox — parity is
distributional, determinism per (epoch, seed) is exact.
"""
from __future__ import annotations

import math

import numpy as np


class EnlargedSampler:
    def __init__(self, dataset, num_replicas: int, rank: int, ratio: int = 1,
                 seed: int = 0):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.seed = seed
        self.num_samples = math.ceil(len(dataset) * ratio / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        g = np.random.default_rng(self.seed + self.epoch)
        indices = g.permutation(self.total_size)[self.rank:self.total_size:self.num_replicas]
        indices = (indices % len(self.dataset)).tolist()
        assert len(indices) == self.num_samples
        return iter(indices)

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch: int):
        self.epoch = epoch
