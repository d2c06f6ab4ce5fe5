"""The distributed runtime: `init_dist`, `get_dist_info`, `master_only`.
Counterpart of `ucdir_tpu/utils/dist.py` (reference utils/dist_utils.py:
10-79). A JAX process is a rank here: one process per card, started by
`torchrun` (or `srun`), joined into one `torch.distributed` process group,
NCCL between cards and gloo on the CPU.

Unlike the JAX package's `init_dist`, which swallows every error and goes on
as one process, `init_dist` raises when the group cannot form: a broken
launch would otherwise train one independent model per process.
"""
from __future__ import annotations

import datetime
import functools
import os
import subprocess
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_PORT = 29500


def _env_int(name: str, launcher: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(
            '--distributed with launcher %r: %s is not set; start the run '
            'with `torchrun --nproc_per_node N -m ucdir_tpu_torch.sr ... '
            '--distributed` (or under srun)'
            % (launcher, name))
    return int(value)


def _slurm_master() -> str:
    """MASTER_ADDR, else the first host of SLURM_NODELIST (as the
    reference's `_init_dist_slurm` finds it)."""
    if os.environ.get('MASTER_ADDR'):
        return os.environ['MASTER_ADDR']
    nodes = os.environ.get('SLURM_NODELIST')
    if not nodes:
        raise RuntimeError('launcher slurm: neither MASTER_ADDR nor '
                           'SLURM_NODELIST is set')
    out = subprocess.run(['scontrol', 'show', 'hostname', nodes],
                         capture_output=True, text=True, check=True)
    return out.stdout.split()[0]


def init_dist(launcher: str = 'pytorch', backend: Optional[str] = None,
              device: str = 'cuda',
              timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Joins this process to the run's process group and returns its
    device: `cuda:LOCAL_RANK` (made the current device) or the CPU.

    launcher: 'pytorch' reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT; 'slurm' reads SLURM_PROCID, SLURM_NTASKS
    and SLURM_LOCALID, MASTER_ADDR (or the first host of SLURM_NODELIST) and
    MASTER_PORT (default 29500). device: 'cuda' or 'cpu'. backend: None
    picks NCCL for 'cuda' and gloo for 'cpu'; gloo on 'cuda' lets several
    ranks share one card (a check, not a way to train). timeout: how long
    the group may take to form (None: torch.distributed's default).

    Raises RuntimeError when a variable is missing, CUDA is absent for
    'cuda', or the group does not form; NotImplementedError for more NCCL
    ranks on a host than it has cards."""
    if launcher == 'pytorch':
        rank = _env_int('RANK', launcher)
        world = _env_int('WORLD_SIZE', launcher)
        local = _env_int('LOCAL_RANK', launcher)
        addr = os.environ.get('MASTER_ADDR')
        if not addr:
            raise RuntimeError('--distributed: MASTER_ADDR is not set')
    elif launcher == 'slurm':
        rank = _env_int('SLURM_PROCID', launcher)
        world = _env_int('SLURM_NTASKS', launcher)
        local = _env_int('SLURM_LOCALID', launcher)
        addr = _slurm_master()
    else:
        raise ValueError('launcher %r: expected pytorch or slurm'
                         % (launcher,))
    port = int(os.environ.get('MASTER_PORT') or DEFAULT_PORT)
    if device not in ('cuda', 'cpu'):
        raise ValueError('device %r: expected cuda or cpu' % (device,))
    backend = backend or ('nccl' if device == 'cuda' else 'gloo')
    dev = torch.device('cpu')
    if device == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('--distributed on cuda, but CUDA is not '
                               'available; pass --device cpu for gloo')
        cards = torch.cuda.device_count()
        if backend == 'nccl' and local >= cards:
            raise NotImplementedError(
                'local rank %d of NCCL on %d card(s): several processes per '
                'card is not ported; see ROADMAP.md' % (local, cards))
        dev = torch.device('cuda', local % cards)
        torch.cuda.set_device(dev)
    kwargs = {} if timeout is None else {'timeout': timeout}
    dist.init_process_group(backend, init_method='tcp://%s:%d' % (addr, port),
                            rank=rank, world_size=world, **kwargs)
    return dev


def get_dist_info() -> Tuple[int, int]:
    """(rank, world_size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def exit_dist():
    """Leaves the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def master_only(func):
    """Runs `func` on rank 0 only (reference dist_utils.py:72-79)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        rank, _ = get_dist_info()
        if rank == 0:
            return func(*args, **kwargs)

    return wrapper
