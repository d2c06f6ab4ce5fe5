"""Builds the CUDA kernels of `csrc/` at first use and binds them with ctypes.

`nvcc -gencode arch=compute_90a,code=sm_90a` compiles every `csrc/*.cu`, one
compiler process per source and all started together, and links them into one
shared library with a plain C interface under `ucdir_tpu_torch/_build/`,
named by a hash of the sources, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Nothing is built or loaded at import: the
CPU tests import every module, and only a CUDA tensor reaches `library()`.

Every C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns `cudaGetLastError()`; `launch` raises when
that is not 0 and counts the launch in `LAUNCHES`. K1..K9 have a second
entry point for bfloat16 operands, `ucdir_<kernel>_bf16` (`entry`), counted
under its own name. The bf16 forms of K1, K2, K3, K5, K6, K7, K8 and K9 run
on the tensor-core core `csrc/igemm_tc.cuh`, which counts its own
successful calls per entry point (`ucdir_tc_launches`; a call of K1, K5 or
K6 once all its launches have gone out); `tc_launches()` reads them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / 'csrc'
BUILD_DIR = PKG / '_build'
GENCODE = 'arch=compute_90a,code=sm_90a'

# Launches per kernel since the last reset_launches(), counted where each
# wrapper launches its kernel and nowhere else.
LAUNCHES = {'akgm_tail': 0, 'conv3x3': 0, 'conv1x1': 0, 'gn1_stats': 0,
            'akgm_tail_bwd': 0, 'conv3x3_bwd': 0, 'conv3x3_preact': 0,
            'akgm_mix': 0, 'akgm_packed': 0,
            'akgm_tail_bf16': 0, 'conv3x3_bf16': 0, 'conv1x1_bf16': 0,
            'gn1_stats_bf16': 0, 'conv3x3_preact_bf16': 0,
            'akgm_tail_bwd_bf16': 0, 'conv3x3_bwd_bf16': 0,
            'akgm_mix_bf16': 0, 'akgm_packed_bf16': 0}
# Launches per kernel form since the last reset_launches(), 'kernel form'
# -> n, for the wrappers that name a form where they launch: K1 and K5
# 'fold' or 'nofold' (a GroupNorm folded in, or none), K2 and K6 the same
# and '+swish' where the swish is applied.
FORMS: dict = {}
# the entry points on the tensor-core core, in the order of the library's
# counters (`ucdir_tc_launches(i)`), and the counts at the last reset
TC_ENTRIES = ('conv3x3_bf16', 'conv3x3_preact_bf16', 'conv1x1_bf16',
              'conv3x3_bwd_bf16', 'akgm_tail_bwd_bf16', 'akgm_tail_bf16',
              'akgm_mix_bf16', 'akgm_packed_bf16')
_tc_base = [0] * len(TC_ENTRIES)
# the kernels with a bfloat16 entry point, `<kernel>_bf16`
BF16_KERNELS = ('akgm_tail', 'conv3x3', 'conv1x1', 'gn1_stats',
                'conv3x3_preact', 'akgm_tail_bwd', 'conv3x3_bwd', 'akgm_mix',
                'akgm_packed')

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers and the stream as void*, sizes and flags as int.
_SIGNATURES = {
    'akgm_tail': [_P] * 12 + [_I] * 4 + [_P],
    'conv3x3': [_P] * 8 + [_I] * 7 + [_P],
    'conv1x1': [_P] * 4 + [_I] * 6 + [_P],
    'gn1_stats': [_P] * 3 + [_I] * 3 + [_P],
    'akgm_tail_bwd': [_P] * 18 + [_I] * 5 + [_P],
    'conv3x3_bwd': [_P] * 12 + [_I] * 7 + [_P],
    'conv3x3_preact': [_P] * 6 + [_I] * 5 + [_P],
    'akgm_mix': [_P] * 5 + [_I] * 4 + [_P],
    'akgm_packed': [_P] * 9 + [_I] * 4 + [_P],
}
_SIGNATURES.update({k + '_bf16': _SIGNATURES[k] for k in BF16_KERNELS})
# K2 and K4 take a workspace for their fixed-order sums and its tile count,
# which the entry point checks against its own
for _k in ('conv3x3', 'conv3x3_bf16'):
    _SIGNATURES[_k] = [_P] * 9 + [_I] * 8 + [_P]
for _k in ('gn1_stats', 'gn1_stats_bf16'):
    _SIGNATURES[_k] = [_P] * 4 + [_I] * 4 + [_P]


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    FORMS.clear()
    if _loaded():
        _tc_base[:] = _tc_counts()


def tc_launches():
    """Per kernel as in LAUNCHES, the launches since the last
    reset_launches() that went through the tensor-core core, as the library
    counts them (all 0 where the library was never loaded)."""
    out = dict.fromkeys(LAUNCHES, 0)
    if _loaded():
        for name, n, base in zip(TC_ENTRIES, _tc_counts(), _tc_base):
            out[name] = n - base
    return out


def _loaded():
    return library.cache_info().currsize > 0


def _tc_counts():
    lib = library()
    return [lib.ucdir_tc_launches(i) for i in range(len(TC_ENTRIES))]


def _nvcc() -> str:
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError('nvcc not found (set NVCC or put the CUDA toolkit on '
                       'PATH); the kernels of ucdir_tpu_torch/csrc are built '
                       'at first use on a CUDA machine')


def _sources():
    return sorted(CSRC.glob('*.cu')), sorted(CSRC.glob('*.cuh'))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f'libucdir_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compiles csrc/*.cu unless a library of these sources exists; returns
    its path. The compiler's output, `-Xptxas -v` included, goes to a .log
    beside it."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc, tag = _nvcc(), f'{so.stem}.{os.getpid()}'
    objs = [so.with_name(f'{tag}.{f.stem}.o') for f in cu]
    procs = [subprocess.Popen(
        [nvcc, '-gencode', GENCODE, '-std=c++17', '-O3', '-Xcompiler',
         '-fPIC', '-Xptxas=-v', '-c', '-o', str(o), str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(cu, objs)]
    log = [p.communicate()[0] for p in procs]
    tmp = so.with_name(f'{tag}.tmp')
    bad = [f.name for f, p in zip(cu, procs) if p.returncode != 0]
    if not bad:
        link = subprocess.run([nvcc, '-shared', '-o', str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            bad = ['the link']
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix('.log').write_text(''.join(log))
    if bad:
        raise RuntimeError('nvcc failed on %s:\n%s'
                           % (', '.join(bad), ''.join(log)[-4000:]))
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, 'ucdir_' + name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ucdir_tc_launches.argtypes = [_I]
    lib.ucdir_tc_launches.restype = ctypes.c_longlong
    return lib


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def entry(kernel: str, t: torch.Tensor) -> str:
    """The entry point of `kernel` for the dtype of `t`: `kernel` for
    float32, `kernel_bf16` for bfloat16 where the kernel has that form. A
    tensor of another dtype raises; nothing is cast."""
    if t.dtype == torch.float32:
        return kernel
    if t.dtype == torch.bfloat16 and kernel in BF16_KERNELS:
        return kernel + '_bf16'
    raise TypeError('%s takes float32%s, got %s; see ROADMAP.md'
                    % (kernel, ' or bfloat16' if kernel in BF16_KERNELS
                       else '', t.dtype))


def check(name: str, t, shape=None, *, device=None, dtype=torch.float32):
    """Raises unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (on `device`, when given). None passes: it stands for an absent
    operand."""
    if t is None:
        return
    if t.device.type != 'cuda':
        raise ValueError('%s: expected a CUDA tensor, got one on %s'
                         % (name, t.device))
    if device is not None and t.device != device:
        raise ValueError('%s: on %s, expected %s' % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError('%s: expected %s, got %s' % (name, dtype, t.dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError('%s: shape %s, expected %s'
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError('%s: must be contiguous' % name)


def launch(kernel: str, *args, form=None):
    """Calls the C entry point `ucdir_<kernel>`, raises on a launch error,
    and counts the launch (in FORMS too under `form`, where given)."""
    err = getattr(library(), 'ucdir_' + kernel)(*args)
    if err != 0:
        raise RuntimeError('%s: kernel launch failed with cudaError %d'
                           % (kernel, err))
    LAUNCHES[kernel] += 1
    if form is not None:
        key = kernel + ' ' + form
        FORMS[key] = FORMS.get(key, 0) + 1


def form(norm_scale, act=None) -> str:
    """A launch's form for FORMS: 'fold' or 'nofold', then '+swish'."""
    return ('nofold' if norm_scale is None else 'fold') + (
        '+swish' if act == 'swish' else '')


def on_host(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrappers then run their plain versions);
    False for a CUDA tensor; raises for any other device."""
    if x.device.type == 'cpu':
        return True
    if x.device.type == 'cuda':
        return False
    raise ValueError('unsupported device %s: the port runs on cuda, or on '
                     'the cpu through its plain versions' % x.device)
