"""Data layer: numpy/PIL datasets, the deterministic sampler and the threaded
prefetching loader, all on the host. Counterpart of `ucdir_tpu/data/`, with
the reference's `create_dataset` / `create_dataloader` string dispatch."""
from ucdir_tpu_torch.data.loader import (create_dataset, create_dataloader,
                                         DataLoader)
from ucdir_tpu_torch.data.sampler import EnlargedSampler
from ucdir_tpu_torch.data.datasets import (
    LRHRDataset, PairDataset, SingleDataset, ImagenetSRDataset,
    ImagenetJPGDataset, ImagenetColorDataset)
