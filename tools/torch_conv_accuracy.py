#!/usr/bin/env python3
"""How exact the forward convolutions K2, K3 and K7 are, and what that does
to the comparison of card and host after ddim.

    python3 tools/torch_conv_accuracy.py [--seeds 0,1] [--runs 3]
    python3 tools/torch_conv_accuracy.py --seeds ''      # part 1 alone
    python3 tools/torch_conv_accuracy.py --seeds '' --gradients   # 1 and 3

1. Each kernel and its plain version (cuDNN, cuBLAS, TF32 off) against the
   same product in float64 on the card, at the widths of the main path and a
   reduced frame: rms, largest and mean error. Two float32 products that add
   in the same order share their rounding, so their difference says nothing
   about either one's distance from the exact product; this does.
2. Per seed: the full-width `dropout: 0` SID model with random weights
   restores a 64 x 64 input with ddim, 3 of the 50 steps, injected noise, once
   on the host and --runs times on the card; prints the max abs difference
   of each card run. The check of `chip_smoke.py` (`fewstep`) is the first
   run of seed 0. DDIM's first step multiplies the network's output by
   1 / sqrt(abar_49) = 349, so this reading is the agreement of card and
   host on eps to about one unit in the last place.
3. With --gradients: the weight and bias gradients of K6 and K5 and of
   their plain versions against the plain version in float64, at train
   shapes (batch 8).

To read another checkout's kernels, put it first on PYTHONPATH: only the
package `ucdir_tpu_torch` comes from there. Needs a CUDA card.
"""
import argparse
import copy
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernels_against_float64(dev):
    import torch
    import torch.nn.functional as F
    from ucdir_tpu_torch.ops import conv
    gen = torch.Generator(dev).manual_seed(11)

    def rnd(*shape, scale=1.0, off=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + off

    def swish(v):
        return v * torch.sigmoid(v)

    def report(label, got, ref):
        e = got.double() - ref
        print('%-40s rms %.3e  max %.3e  mean %+.3e  (values rms %.3f)'
              % (label, e.pow(2).mean().sqrt().item(), e.abs().max().item(),
                 e.mean().item(), ref.pow(2).mean().sqrt().item()), flush=True)

    def conv3x3(label, H, W, cin, cout, fold=False, act=None, pre=False,
                stride=1):
        x = rnd(1, H, W, cin, scale=0.5)
        w = rnd(9 * cin, cout, scale=(9 * cin) ** -0.5)
        b = rnd(cout, scale=0.1)
        a = rnd(1, cin, scale=0.2, off=1.0) if fold else None
        t = rnd(1, cin, scale=0.2) if fold else None
        xd = x.double()
        if fold:
            xd = xd * a.double()[:, None, None, :] + t.double()[:, None, None, :]
        if pre:
            xd = swish(xd)
        k = w.double().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
        ref = F.conv2d(xd.permute(0, 3, 1, 2), k.contiguous(), b.double(),
                       stride=stride, padding=1).permute(0, 2, 3, 1)
        if act:
            ref = swish(ref)
        if pre:
            got = conv.conv3x3_preact(x, w, b, a, t)
            plain = conv.conv3x3_preact_plain(x, w, b, a, t)
        else:
            kw = dict(stride=stride, act=act, norm_scale=a, norm_shift=t)
            got = conv.conv3x3(x, w, b, **kw)
            plain = conv.conv3x3_plain(x, w, b, **kw)
        report(label, got, ref)
        report(label + ' [plain]', plain, ref)

    def conv1x1(label, H, W, cin, cout):
        x = rnd(1, H, W, cin, scale=0.5)
        w = rnd(cin, cout, scale=cin ** -0.5)
        b = rnd(cout, scale=0.1)
        ref = (x.double().reshape(-1, cin) @ w.double()
               + b.double()).reshape(1, H, W, cout)
        report(label, conv.conv1x1(x, w, b), ref)
        report(label + ' [plain]', conv.conv1x1_plain(x, w, b), ref)

    with torch.no_grad():
        conv3x3('K2 192->64 fold+swish 384x384', 384, 384, 192, 64,
                fold=True, act='swish')
        conv3x3('K2 192->64 fold 384x384', 384, 384, 192, 64, fold=True)
        conv3x3('K2 64->64 stride 2 384x384', 384, 384, 64, 64, stride=2)
        conv3x3('K2 128->512 192x192', 192, 192, 128, 512)
        conv3x3('K2 1024->512 fold+swish 96x96', 96, 96, 1024, 512,
                fold=True, act='swish')
        conv3x3('K2 64->3 384x384', 384, 384, 64, 3)
        conv3x3('K7 64->3 fold 384x384', 384, 384, 64, 3, fold=True,
                pre=True)
        conv1x1('K3 192->64 384x384', 384, 384, 192, 64)
        conv1x1('K3 1024->512 96x96', 96, 96, 1024, 512)


def ddim_card_against_host(dev, smoke, seeds, runs):
    import numpy as np
    import torch
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.schedule import make_schedule
    pad = smoke.PAD
    kw = dict(sampler='ddim', sampling_timesteps=3)
    for seed in seeds:
        host = smoke.build_model(seed, dropout=0.0)
        card = copy.deepcopy(host).to(dev)
        rng = np.random.default_rng(seed + 7)
        x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
        shape = (1, 64 + 2 * pad, 64 + 2 * pad, 3)
        draws = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(4)]
        want = eval_step(host, make_schedule(SID_VAL_SCHEDULE, 'cpu'),
                         torch.from_numpy(x),
                         noise=smoke.injected(draws, 'cpu'), **kw)[0]
        sched = make_schedule(SID_VAL_SCHEDULE, dev)
        errs = []
        for _ in range(runs):
            got = eval_step(card, sched, torch.from_numpy(x).to(dev),
                            noise=smoke.injected(draws, dev), **kw)[0]
            errs.append((got.cpu() - want).abs().max().item())
        print('seed %d, ddim 3 of 50 steps, 64x64, card vs host max abs err: %s'
              % (seed, ' '.join('%.3e' % e for e in errs)), flush=True)


def gradients_against_float64(dev):
    """The weight and bias gradients of K6 and K5, the kernel's and the plain
    version's, against the plain version in float64, at train shapes (batch
    8): the largest error over the largest |float64 value| of each output.
    The kernel's reading against the float32 plain version (phase 2 of
    chip_smoke.py) holds both sides' rounding."""
    import torch
    from ucdir_tpu_torch.ops import akgm, conv
    gen = torch.Generator(dev).manual_seed(12)

    def rnd(*shape, scale=1.0, off=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + off

    def report(label, names, got, plain, ref):
        for n, g, p, r in zip(names, got, plain, ref):
            big = r.abs().max().item()
            print('%-44s %-5s kernel %.3e  plain %.3e  kernel vs plain %.3e '
                  '(of the largest |value|)'
                  % (label, n, (g.double() - r).abs().max().item() / big,
                     (p.double() - r).abs().max().item() / big,
                     (g - p).abs().max().item() / p.abs().max().item()),
                  flush=True)

    def k6(label, B, H, cin, cout, act):
        x, go = rnd(B, H, H, cin, scale=0.5), rnd(B, H, H, cout)
        w = rnd(9 * cin, cout, scale=(9 * cin) ** -0.5)
        b = rnd(cout, scale=0.1)
        a, t = rnd(B, cin, scale=0.2, off=1.0), rnd(B, cin, scale=0.2)
        got = conv.conv3x3_backward_kernel(x, w, b, go, act, a, t)
        plain = conv.conv3x3_backward_plain(x, w, b, go, act=act,
                                            norm_scale=a, norm_shift=t)
        ref = conv.conv3x3_backward_plain(
            x.double(), w.double(), b.double(), go.double(), act=act,
            norm_scale=a.double(), norm_shift=t.double())
        report(label, ('dw', 'dbias'), got[1:], plain[1:], ref[1:])

    def k5(label, B, H, C):
        G = 8
        h, go = rnd(B, H, H, C, scale=0.5), rnd(B, H, H, C)
        att, aw = rnd(B, H, H, G, scale=0.5), rnd(B, G, scale=0.3, off=1.0)
        w = rnd(9 * C // G, C * G, scale=(9 * C / G) ** -0.5)
        b = rnd(C * G, scale=0.1)
        a, t = rnd(B, C, scale=0.2, off=1.0), rnd(B, C, scale=0.2)
        got = akgm.akgm_block_tail_backward_kernel(h, att, w, b, go, G, a, t,
                                                   aw)
        plain = akgm.akgm_block_tail_backward_plain(
            h, att, w, b, go, G, norm_scale=a, norm_shift=t, attw=aw)
        d = [v.double() for v in (h, att, w, b, go, a, t, aw)]
        ref = akgm.akgm_block_tail_backward_plain(
            *d[:5], G, norm_scale=d[5], norm_shift=d[6], attw=d[7])
        report(label, ('dw', 'dbias'), got[2:4], plain[2:4], ref[2:4])

    with torch.no_grad():
        k6('K6 B=8 conv1 192->64 288x288 fold+swish', 8, 288, 192, 64,
           'swish')
        k6('K6 B=8 conv1 1024->512 36x36 fold+swish', 8, 36, 1024, 512,
           'swish')
        k6('K6 B=8 downs_0 6->64 288x288', 8, 288, 6, 64, None)
        k5('K5 B=8 C=64 288x288 fold+attw', 8, 288, 64)
        k5('K5 B=8 C=512 36x36 fold+attw', 8, 36, 512)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seeds', default='0,1')
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--gradients', action='store_true',
                    help='also part 3: K5 and K6 weight gradients')
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('torch_conv_accuracy: CUDA is not available', file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.append(ROOT)   # after PYTHONPATH: another checkout's package wins
    dev = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    print(smoke.nvidia_smi())
    kernels_against_float64(dev)
    if args.gradients:
        gradients_against_float64(dev)
    seeds = [int(seed) for seed in args.seeds.split(',') if seed]
    ddim_card_against_host(dev, smoke, seeds, args.runs)
    return 0


if __name__ == '__main__':
    sys.exit(main())
