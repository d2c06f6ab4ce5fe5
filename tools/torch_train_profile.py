#!/usr/bin/env python3
"""Where one SID train step, or one SID validation frame, of the PyTorch
port goes on the card.

    python3 tools/torch_train_profile.py [--batch 32] [--crop 256] [--seed 0]
                                         [--compute_dtype bf16]
    python3 tools/torch_train_profile.py --val [--steps 2] [--seed 0]
                                         [--tail fused|mix|packed]
                                         [--compute_dtype bf16]

Builds the Trainer of `ucdir_tpu_torch` in its train phase at the full SID
width (random weights from --seed, one seeded batch), takes two warm-up steps,
times three steps with the host clock around `torch.cuda.synchronize()`, then
traces one more step with `torch.profiler` and prints: seconds per step, peak
memory, the device's busy time and idle share inside the traced step, the
time of each CUDA kernel by name (top 30), the port's kernels by launch (K1's
two, K2 bf16's and K4 bf16's two: the product or the sums, and the
statistics' reduction; K1, K2, K3, K5, K6 and K7 in bf16 on the tensor
cores apart from their FMA forms; K5's
and K6's three: z recompute, weight gradient and its reduction, input
gradient) and the
launches of K1..K6 in that step, and the casts' time (`aten::_to_copy` and
its copy kernels: the parameters' cast to bf16 and the casts around
attention and the loss). With --val it restores one 1424 x 2128 frame (1568
x 2272 in the network) with --steps DDPM steps instead, once to warm up and
once traced: the same lines for that frame, whose time is one predictor
pass plus --steps DY3h steps, with --tail the denoiser's AKGM tail
(`DY3h(tail=...)`: K1, K8 or K9). --compute_dtype bf16 runs the networks in
bfloat16 (the bf16 kernels): validation on a bf16 copy of the weights,
training on a bf16 cast of the float32 masters. Needs a CUDA card; prints
the card's name and power limit first.
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
    ap.add_argument('--val', action='store_true',
                    help='trace a validation frame instead of a train step')
    ap.add_argument('--steps', type=int, default=2,
                    help='DDPM steps of the traced validation frame')
    ap.add_argument('--tail', default='fused',
                    choices=('fused', 'mix', 'packed'),
                    help="the validation denoiser's AKGM tail")
    ap.add_argument('--compute_dtype', default=None, choices=('bf16',),
                    help="the networks' dtype")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from ucdir_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print('torch_train_profile: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device('cuda', 0)
    if args.val:
        step = val_frame(dev, args.seed, args.steps, args.tail,
                         args.compute_dtype)
    else:
        step = train_step(dev, args)
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t
    print('launches in the traced %s: %s'
          % ('frame' if args.val else 'step', json.dumps(_build.LAUNCHES)))
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type.name == 'CUDA']   # kernels, not the ops over them
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print('traced %.1f ms on the host clock; device busy %.1f ms, idle '
          'share %.2f%%' % (1e3 * traced, busy,
                            100 * max(0.0, 1 - busy / (1e3 * traced))))
    for name, ms, count in rows[:30]:
        print('%10.2f ms %5.1f%% %6d x  %s' % (ms, 100 * ms / busy, count,
                                               name[:90]))
    parts = {}
    for name, ms, count in rows:
        part = launch_part(name)
        if part:
            t, n = parts.get(part, (0.0, 0))
            parts[part] = (t + ms, n + count)
    print('the port\'s kernels by launch:')
    for part, (ms, count) in sorted(parts.items()):
        print('%10.2f ms %6d x  %s' % (ms, count, part))
    casts = [(e.device_time_total / 1e3, e.count) for e in
             prof.key_averages() if e.key == 'aten::_to_copy']
    print('casts (aten::_to_copy, device time of its kernels): %.2f ms in '
          '%d calls' % (sum(c[0] for c in casts), sum(c[1] for c in casts)))
    return 0


# kernel name -> the port's kernel and launch (csrc/*.cu), first match wins
PARTS = (
    # the bf16 forms of K5 and K6 on the tensor cores (igemm_tc.cuh)
    (('gconv_tc_kernel', 'TailEpi'), 'K1 bf16 (tensor cores)'),
    (('gconv_tc_kernel', 'MixEpi'), 'K5 bf16 do (z recompute, tensor cores)'),
    (('gconv_tc_kernel', 'Dz'), 'K5 bf16 dh (input gradient, tensor cores)'),
    (('wgrad_tc_kernel', ', true'), 'K5 bf16 dW (tensor cores)'),
    (('wgrad_tc_kernel', ', false'), 'K6 bf16 dW (tensor cores)'),
    (('wgrad_reduce_kernel', 'WgradTc'), 'K5 and K6 bf16 dW reductions'),
    (('gconv_tc_kernel', 'OutEpi<true>'), 'K6 bf16 dz (z recompute, '
     'tensor cores)'),
    (('gconv_tc_kernel', 'Dgrad'), 'K6 bf16 dx (input gradient, tensor '
     'cores)'),
    (('akgm_do_kernel',), 'K5 do (z recompute)'),
    (('dattw_reduce_kernel',), 'K5 dattw reduction'),
    (('wgrad_pc_kernel', 'DzD'), 'K5 dW'),
    (('wgrad_reduce_kernel', 'DzD'), 'K5 dW reduction'),
    (('akgm_dh_kernel',), 'K5 dh (input gradient)'),
    (('conv_pc_kernel', 'Affine, true'), 'K6 dz (z recompute)'),
    (('wgrad_pc_kernel', 'PlainD'), 'K6 dW'),
    (('wgrad_reduce_kernel', 'PlainD'), 'K6 dW reduction'),
    (('conv_pc_kernel', 'Dgrad'), 'K6 dx (input gradient)'),
    (('conv_pc_kernel', 'Raw'), 'K3'),
    (('conv_pc_kernel', 'Preact'), 'K7'),
    (('conv_pc_kernel', 'Affine'), 'K2'),
    # the bf16 forms of K2, K3 and K7 on the tensor cores (igemm_tc.cuh)
    (('conv_tc_kernel', 'Raw'), 'K3 bf16 (tensor cores)'),
    (('conv_tc_kernel', 'Preact'), 'K7 bf16 (tensor cores)'),
    (('conv_tc_kernel', 'Affine'), 'K2 bf16 (tensor cores)'),
    (('conv_stats_kernel',), 'K2 bf16 statistics reduction'),
    (('akgm_tail_kernel', ', true,'), 'K1'),
    (('stats_reduce_kernel',), 'K1 and K4 bf16 statistics reductions'),
    (('akgm_tail_kernel', ', false,'), 'K8'),
    (('gn1_slab',), 'K4 bf16'),
    (('gn1_stats',), 'K4'),
    (('akgm_packed_kernel',), 'K9'),
)


def launch_part(name):
    for keys, part in PARTS:
        if all(k in name for k in keys):
            return part
    return None


def val_frame(dev, seed, steps, tail='fused', compute_dtype=None):
    """Warms up and returns a call that restores one SID frame."""
    import torch
    from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.models.factory import define_G
    from ucdir_tpu_torch.schedule import make_schedule

    model_opt = copy.deepcopy(SID_MODEL)
    model_opt['beta_schedule']['val'] = dict(SID_VAL_SCHEDULE)
    model_opt['unet']['tail'] = tail
    torch.manual_seed(seed)
    model = define_G({'model': model_opt}).eval().to(dev)
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=steps), dev)
    gen = torch.Generator(dev).manual_seed(seed)
    frame = torch.rand((1, 1424, 2128, 3), generator=gen, device=dev) * 2 - 1

    dtype = {'bf16': torch.bfloat16}.get(compute_dtype)

    def step():
        eval_step(model, sched, frame, pad=64, generator=gen,
                  compute_dtype=dtype)

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    step()
    torch.cuda.synchronize()
    print("frame 1424x2128 (network 1568x2272), tail '%s', %d DDPM steps, "
          '%s: %.3f s' % (tail, steps, compute_dtype or 'float32',
                          time.perf_counter() - t))
    return step


def train_step(dev, args):
    """Warms up, times three steps and returns a call that takes one more."""
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_MODEL
    from ucdir_tpu_torch.trainer import Trainer

    opt = {'phase': 'train', 'model': copy.deepcopy(SID_MODEL),
           'compute_dtype': args.compute_dtype,
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
    print('batch %d, crop %d, %s: %.3f s per step (mean of 3), peak %.3f GiB'
          % (args.batch, args.crop, args.compute_dtype or 'float32', secs,
             peak))

    return trainer.optimize_parameters


if __name__ == '__main__':
    sys.exit(main())
