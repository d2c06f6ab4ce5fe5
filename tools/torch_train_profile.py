#!/usr/bin/env python3
"""Where one SID train step of the PyTorch port goes on the card.

    python3 tools/torch_train_profile.py [--batch 32] [--crop 256] [--seed 0]

Builds the Trainer of `ucdir_tpu_torch` in its train phase at the full SID
width (random weights from --seed, one seeded batch), takes two warm-up steps,
times three steps with the host clock around `torch.cuda.synchronize()`, then
traces one more step with `torch.profiler` and prints: seconds per step, peak
memory, the device's busy time and idle share inside the traced step, the
time of each CUDA kernel by name (top 30) and the launches of K1..K6 in that
step. Needs a CUDA card; prints the card's name and power limit first.
"""
import argparse
import copy
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--crop', type=int, default=256)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ucdir_tpu_torch.configs import SID_MODEL
    from ucdir_tpu_torch.ops import _build
    from ucdir_tpu_torch.trainer import Trainer

    if not torch.cuda.is_available():
        print('torch_train_profile: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device('cuda', 0)
    opt = {'phase': 'train', 'model': copy.deepcopy(SID_MODEL),
           'path': {'resume_state': None, 'checkpoint': None},
           'train': {'optimizer': {'type': 'adamw', 'lr': 1e-4},
                     'ema_scheduler': {'use': True, 'step_start_ema': 5000,
                                       'update_ema_every': 1,
                                       'ema_decay': 0.9999}}}
    trainer = Trainer(opt, device=dev, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    shape = (args.batch, args.crop, args.crop, 3)
    hr = rng.uniform(-0.8, 0.8, shape).astype(np.float32)
    trainer.feed_data({'HR': hr, 'SR': (0.2 * hr + rng.normal(
        0, 0.05, shape)).astype(np.float32)})
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        trainer.optimize_parameters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        trainer.optimize_parameters()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t) / 3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print('batch %d, crop %d: %.3f s per step (mean of 3), peak %.3f GiB'
          % (args.batch, args.crop, secs, peak))

    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.optimize_parameters()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t
    print('launches in the traced step: %s' % json.dumps(_build.LAUNCHES))
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type.name == 'CUDA']   # kernels, not the ops over them
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print('traced step %.1f ms on the host clock; device busy %.1f ms, idle '
          'share %.2f%%' % (1e3 * traced, busy,
                            100 * max(0.0, 1 - busy / (1e3 * traced))))
    for name, ms, count in rows[:30]:
        print('%10.2f ms %5.1f%% %6d x  %s' % (ms, 100 * ms / busy, count,
                                               name[:90]))
    return 0


if __name__ == '__main__':
    sys.exit(main())
