#!/usr/bin/env python3
"""Where the time of K6 (the 3x3 conv backward) and of the library's
backward goes, launch by launch, at four train shapes of the SID model; with
--k5, of K5 (the AKGM tail backward) and its plain version at three widths.

    python3 tools/torch_bwd_split.py [--k5]

For each case: `conv.conv3x3_backward_kernel` (K6: the z recompute, the
weight gradient and its reduction, the input gradient) and
`aten.convolution_backward` (cuDNN, TF32 off), five calls each under
`torch.profiler`; prints each kernel's device ms per call, the four largest.
The library may pick another algorithm than a direct product (FFT, GEMM on
an unfolded input), which changes the work it does. --k5:
`akgm.akgm_block_tail_backward_kernel` (the z recompute and do, dattw's
reduction, the weight gradient and its reduction, the input gradient) and
`akgm_block_tail_backward_plain` at C = 32 (288 x 288), 192 (36 x 36) and 64
(288 x 288), batch 8, with the affine and attw. Needs a CUDA card; prints
the card's name and power limit first.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (batch, height = width, cin, cout, folded affine, activation)
CASES = ((8, 144, 128, 512, False, None), (8, 288, 192, 64, True, 'swish'),
         (8, 288, 6, 64, False, None), (8, 36, 1024, 512, True, 'swish'))
# K5: (batch, height = width, C)
CASES_K5 = ((8, 288, 32), (8, 36, 192), (8, 288, 64))


def split(name, fn):
    """Prints fn's device ms per call by kernel, the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 5e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type.name == 'CUDA'), reverse=True)
    print('%s: %.3f ms: %s' % (name, sum(r[0] for r in rows), ' | '.join(
        '%.3f ms %s' % (ms, key[:90]) for ms, key in rows[:6])), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--k5', action='store_true',
                    help='K5 and its plain version instead of K6')
    args = ap.parse_args(argv)
    import torch
    from ucdir_tpu_torch.ops import akgm, conv

    if not torch.cuda.is_available():
        print('torch_bwd_split: CUDA is not available', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    gen = torch.Generator(dev).manual_seed(0)

    def rnd(*shape, scale=1.0, off=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + off

    if args.k5:
        G = 8
        for B, H, C in CASES_K5:
            h, go = rnd(B, H, H, C, scale=0.5), rnd(B, H, H, C)
            att = rnd(B, H, H, G, scale=0.5)
            w = rnd(9 * C // G, C * G, scale=(9 * C / G) ** -0.5)
            b = rnd(C * G, scale=0.1)
            ns, nt = rnd(B, C, scale=0.2, off=1.0), rnd(B, C, scale=0.2)
            aw = rnd(B, G, scale=0.3, off=1.0)
            split('B=%d %dx%d C=%d K5' % (B, H, H, C),
                  lambda: akgm.akgm_block_tail_backward_kernel(
                      h, att, w, b, go, G, ns, nt, aw))
            split('B=%d %dx%d C=%d plain' % (B, H, H, C),
                  lambda: akgm.akgm_block_tail_backward_plain(
                      h, att, w, b, go, G, norm_scale=ns, norm_shift=nt,
                      attw=aw))
        return 0

    for B, H, cin, cout, fold, act in CASES:
        x, go = rnd(B, H, H, cin, scale=0.5), rnd(B, H, H, cout)
        w = rnd(9 * cin, cout, scale=(9 * cin) ** -0.5)
        b = rnd(cout, scale=0.1)
        a = rnd(B, cin, scale=0.2, off=1.0) if fold else None
        t = rnd(B, cin, scale=0.2) if fold else None
        k = w.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
        calls = (
            ('K6', lambda: conv.conv3x3_backward_kernel(x, w, b, go, act, a,
                                                        t)),
            ('library', lambda: torch.ops.aten.convolution_backward(
                go.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), k, [cout],
                [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, True, True])))
        for name, fn in calls:
            split('B=%d %dx%d %d->%d %s %s' % (B, H, H, cin, cout,
                                              act or 'linear', name), fn)
    return 0


if __name__ == '__main__':
    sys.exit(main())
