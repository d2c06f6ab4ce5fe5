#!/usr/bin/env python3
"""Where one Real-SR degradation feed (`ucdir_tpu_torch.realsr.TrainerRealSR.
feed_data`) goes on the card.

    python3 tools/torch_feed_profile.py [--batch 12] [--crop 400] [--feeds 8]
                                        [--seed 0]

Builds a DDPM_realsr trainer with the `dopt` preset (gt_size 256, a queue
of 180; its network at toy width, which the feed never runs), makes batches
of RealESRGANDataset items from generated --crop x --crop images (the
dataset's own kernel and sinc draws), feeds three to warm up, times --feeds
feeds with the host clock around `torch.cuda.synchronize()`, then traces
--feeds more with `torch.profiler` and prints: ms per feed (median, and
each), the device's busy time and idle share in the traced feeds, the time
of each step of the feed (the sharpening, the blurs, the resizes, the
noises, DiffJPEG, the crop and the queue; host time and the device time of
the kernels each launched), the CUDA kernels by name (top 15), and the
host-to-device copies and stream synchronizations per feed. Needs a CUDA
card; prints the card's name and power limit first.
"""
import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the feed's steps, as the functions realsr.py calls
STEPS = ('usm_sharp', 'filter2D', 'interpolate', 'random_add_gaussian_noise_pt',
         'random_add_poisson_noise_pt', 'gaussian_noise_draws',
         'poisson_noise_draws', 'diff_jpeg', 'paired_random_crop',
         '_dequeue_and_enqueue')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=12)
    ap.add_argument('--crop', type=int, default=400)
    ap.add_argument('--feeds', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import random
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from ucdir_tpu_torch import realsr
    from ucdir_tpu_torch.configs import SID_MODEL

    if not torch.cuda.is_available():
        sys.exit('torch_feed_profile: CUDA is not available')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print('card: %s (%s)' % (torch.cuda.get_device_name(0), smi), flush=True)
    dev = torch.device('cuda', 0)

    def labelled(name, fn):
        def call(*a, **kw):
            with record_function('feed.' + name):
                return fn(*a, **kw)
        return call

    for name in STEPS:
        if hasattr(realsr, name):
            setattr(realsr, name, labelled(name, getattr(realsr, name)))
    cls = realsr.TrainerRealSR
    cls._dequeue_and_enqueue = labelled('_dequeue_and_enqueue',
                                        cls._dequeue_and_enqueue)

    model = dict(SID_MODEL, name='DDPM_realsr')
    model['unet'] = dict(model['unet'], inner_channel=8, channel_mults=[1, 2],
                         attn_res=[], res_blocks=1)
    with tempfile.TemporaryDirectory() as tmp:
        txt = os.path.join(tmp, 'list.txt')
        with open(txt, 'w') as f:
            f.write('\n'.join('%d.png' % i for i in range(args.batch)))
        ds = realsr.RealESRGANDataset({'root': tmp, 'txt': txt},
                                      split='train', crop_size=args.crop)
        trainer = cls({'phase': 'train', 'model': model, 'dopt': 'dopt',
                       'path': {'resume_state': None, 'checkpoint': tmp},
                       'train': {'optimizer': {'type': 'adamw', 'lr': 1e-4},
                                 'ema_scheduler': {'use': False}}},
                      device=dev, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    yy, xx = np.mgrid[0:args.crop, 0:args.crop] / (args.crop - 1.0)
    images = [np.clip(np.stack([np.sin((2 + i) * xx + c)
                                * np.cos((3 + i) * yy - c)
                                for c in range(3)], -1) * 0.4 + 0.5
                      + rng.normal(0, 0.05, (args.crop, args.crop, 3)),
                      0, 1).astype(np.float32) for i in range(args.batch)]
    random.seed(args.seed), np.random.seed(args.seed)
    keys = ('gt', 'kernel1', 'kernel2', 'sinc_kernel')
    batches = []
    for _ in range(3 + 2 * args.feeds):
        items = [ds.from_image(img, i) for i, img in enumerate(images)]
        batches.append({k: np.stack([it[k] for it in items]) for k in keys})

    for batch in batches[:3]:
        trainer.feed_data(batch)
    torch.cuda.synchronize()
    ms = []
    for batch in batches[3:3 + args.feeds]:
        t = time.perf_counter()
        trainer.feed_data(batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    print('feed, batch %d, crop %d -> gt_size %d: median %.2f ms (%s)'
          % (args.batch, args.crop, trainer.dopt['gt_size'],
             statistics.median(ms), ' '.join('%.2f' % v for v in ms)))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for batch in batches[3 + args.feeds:]:
            trainer.feed_data(batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    events = prof.key_averages()

    # kernels and copies, not the feed's ranges, which the trace also keeps
    # on the device's timeline (from a range's first kernel to its last)
    kernels = [e for e in events if e.device_type.name == 'CUDA'
               and not e.key.startswith('feed.')]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n = args.feeds
    print('traced %d feeds: %.2f ms per feed on the host clock, device busy '
          '%.2f ms per feed, idle share %.2f%%'
          % (n, wall / n, busy / n, 100 * max(0.0, 1 - busy / wall)))
    print('by step of the feed, per feed: host ms, device ms of its kernels '
          '(calls)')
    for e in sorted((e for e in events if e.key.startswith('feed.')
                     and e.device_type.name == 'CPU'),
                    key=lambda e: -e.device_time_total):
        print('  %-36s %8.3f %8.3f  (%.1f)' % (
            e.key[5:], e.cpu_time_total / 1e3 / n,
            e.device_time_total / 1e3 / n, e.count / n))
    print('CUDA kernels by device time, per feed (ms, launches):')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print('  %8.3f  %6.1f  %s' % (e.self_device_time_total / 1e3 / n,
                                      e.count / n, e.key[:100]))
    for key in ('cudaStreamSynchronize', 'cudaMemcpyAsync',
                'cudaDeviceSynchronize', 'aten::copy_'):
        hits = [e for e in events if e.key == key]
        if hits:
            print('%s: %.1f calls per feed, %.3f ms host per feed'
                  % (key, hits[0].count / n, hits[0].cpu_time_total / 1e3 / n))


if __name__ == '__main__':
    main()
