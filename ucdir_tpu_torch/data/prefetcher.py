"""Device prefetchers. Counterpart of `ucdir_tpu/data/prefetcher.py`
(reference data/prefetcher.py, a CPU and a CUDA prefetcher with a side
stream).

`DevicePrefetcher` keeps up to `depth` batches on their way to the card
while the current step runs: each batch's tensors go to pinned host memory
and then to the card with non-blocking copies on a side CUDA stream; a
batch is handed out only once the current stream has waited for its copy.
On the CPU it hands the batches out as they come.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class DevicePrefetcher:
    """Wraps a host batch iterator (dicts of arrays or tensors); yields the
    batches in order with their arrays as tensors on `device`, `depth` of
    them in flight. Values that are neither arrays nor tensors pass as they
    are."""

    def __init__(self, loader, device: Optional[torch.device] = None,
                 depth: int = 2):
        self.loader = loader
        self.device = torch.device(device if device is not None else
                                   ('cuda' if torch.cuda.is_available()
                                    else 'cpu'))
        self.depth = max(1, depth)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == 'cuda' else None)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, 'set_epoch'):
            self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def _put(self, batch: Dict[str, Any]):
        """(the batch on the device, the event its copies end with)."""
        out = {}
        if self.stream is None:
            for k, v in batch.items():
                out[k] = (torch.as_tensor(v) if isinstance(v, np.ndarray)
                          else v)
            return out, None
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    v = torch.from_numpy(np.ascontiguousarray(v))
                if torch.is_tensor(v):
                    v = v.pin_memory().to(self.device, non_blocking=True)
                out[k] = v
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = iter(self.loader)
        queue = deque()
        for batch in it:
            queue.append(self._put(batch))
            if len(queue) == self.depth:
                break
        while queue:
            out, done = queue.popleft()
            if done is not None:
                torch.cuda.current_stream(self.device).wait_event(done)
                for v in out.values():
                    if torch.is_tensor(v):
                        # the side stream's memory is now used on this one
                        v.record_stream(torch.cuda.current_stream(
                            self.device))
            nxt = next(it, None)
            if nxt is not None:
                queue.append(self._put(nxt))
            yield out


class CPUPrefetcher:
    """The loader as it is: its workers already prefetch batches (the JAX
    package's alias, kept for the same surface)."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        return iter(self.loader)

    def __len__(self):
        return len(self.loader)
