"""The data axis across ranks. Counterpart of `ucdir_tpu/parallel/mesh.py`,
whose mesh shards the global batch over `P('data')` and lets jit insert the
gradient all-reduce. Here each rank holds its rows of the global batch
(`data_shard`), draws what the step draws at the global batch and keeps its
rows (`DataShard`), and all-reduces the gradients explicitly
(`all_reduce_mean_`). NCCL and gloo give every rank the same bits of an
all-reduce, so the parameters, the optimizer state and the EMA stay
identical across ranks without a broadcast after the first.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import torch
import torch.distributed as dist


def data_shard(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank `rank`'s rows of the global-batch tensor `t`: the rank-th of
    `world` equal slices of dim 0, the counterpart of `P('data')`."""
    if t.shape[0] % world:
        raise ValueError('a global batch of %d does not split over %d ranks'
                         % (t.shape[0], world))
    b = t.shape[0] // world
    return t[rank * b:(rank + 1) * b]


class DataShard:
    """Draws from `generator` made at the global batch, of which a rank
    keeps its rows: one rank's share of what one process with the whole
    batch draws. A drawing function that finds one (the head's dropout mask,
    `models.layers.dropout_mask`) calls its `rand` instead of `torch.rand`."""

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        self.generator, self.rank, self.world = generator, rank, world

    def rand(self, shape: Sequence[int], **kwargs) -> torch.Tensor:
        shape = (shape[0] * self.world,) + tuple(shape[1:])
        return data_shard(torch.rand(shape, generator=self.generator,
                                     **kwargs), self.rank, self.world)


def _backend_device(t: torch.Tensor) -> torch.device:
    """Where a collective on `t`'s values runs: on `t`'s card under NCCL,
    on the host under gloo (which also serves ranks sharing one card)."""
    if dist.get_backend() == 'nccl':
        return t.device
    return torch.device('cpu')


def all_reduce_mean_(tensors: Iterable[torch.Tensor]):
    """Replaces each tensor by its mean over the ranks: all flattened into
    one float32 buffer, all-reduced with a sum, divided by the world size,
    copied back. Does nothing without a process group; on a group of one
    rank it leaves every bit as it was."""
    tensors: List[torch.Tensor] = list(tensors)
    if not tensors or not dist.is_initialized():
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    buf = flat.to(_backend_device(flat))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    flat = buf.to(flat.device).div_(dist.get_world_size())
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0):
    """Copies rank `src`'s values of every tensor to every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for t in tensors:
        buf = t.detach().to(_backend_device(t))
        dist.broadcast(buf, src)
        t.detach().copy_(buf)


def global_sums(values: Sequence[float]) -> List[float]:
    """Each value summed over the ranks, in float64 (itself without a
    process group of more than one rank)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [float(v) for v in values]
    dev = (torch.device('cuda', torch.cuda.current_device())
           if dist.get_backend() == 'nccl' else torch.device('cpu'))
    buf = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.cpu().tolist()


def barrier():
    """Waits until every rank has reached it (nothing to wait for without a
    process group of more than one rank)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == 'nccl':
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
