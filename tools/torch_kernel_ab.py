#!/usr/bin/env python3
"""Times the port's kernels from two trees in one process group on one card.

    python3 tools/torch_kernel_ab.py --parent DIR [--kernels conv3x3,conv1x1]
                                     [--ddim]

DIR holds another checkout of the repository (for example `git archive` of
the parent commit, unpacked into a directory that .gitignore lists). The
cases and the timing are those of phase 2 of this tree's chip_smoke.py
(`kernel_cases`, `timed`); only the
package `ucdir_tpu_torch` (and so the kernels' sources) comes from the tree
under test. The trees run in turns, parent, change, change, parent, each in a
process of its own that builds its kernels, so that a drift of the card
between calls cannot pass for a difference between the trees. Prints each
run's lines, then one line per case with the four times and, per output of
the case, whether the parent's first run and the change's first run gave
the same bits (a hash of the output's bytes). With --ddim each run also
prints the reading of chip_smoke.py's `fewstep` check: ddim, 3 steps, the
`dropout: 0` model on the card against the host, max abs error.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(t):
    import torch
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def worker(kernels, seed, ddim):
    """The cases of chip_smoke.py's phase 2 for `kernels`, on the
    `ucdir_tpu_torch` that sys.path gives; prints 'CASE <json>' per case,
    and with ddim 'DDIM <max abs error>'."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_build()
    gen = torch.Generator(dev).manual_seed(seed)
    for case in chip_smoke.kernel_cases(gen, dev):
        if case['name'] not in kernels:
            continue
        label = '%s %s' % (case['name'], case['label'])
        try:
            got = chip_smoke.flat(case['kernel']())
        except (ValueError, TypeError) as e:
            # a width or a dtype this tree's kernel does not take
            print('CASE ' + json.dumps({'case': label, 'refused': str(e)}),
                  flush=True)
            continue
        err = (got[0] - chip_smoke.flat(case['plain']())[0]).abs().max().item()
        hashes = [digest(t) for t in got]
        del got
        print('CASE ' + json.dumps({
            'case': label, 'ms': chip_smoke.timed(case['kernel'], 5),
            'err': err, 'hashes': hashes}), flush=True)
        torch.cuda.empty_cache()
    if ddim:
        import copy
        host = chip_smoke.build_model(seed, dropout=0.0)
        model = copy.deepcopy(host).to(dev)
        got, want = chip_smoke.ddim_card_and_host(dev, seed, model, host)
        print('DDIM %.3e' % (got.cpu() - want).abs().max().item(), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='root of the other checkout')
    ap.add_argument('--kernels', default='conv3x3,conv1x1,conv3x3_preact')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--ddim', action='store_true',
                    help="also read fewstep's ddim card-vs-host check")
    ap.add_argument('--worker', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kernels = tuple(args.kernels.split(','))
    if args.worker:
        worker(kernels, args.seed, args.ddim)
        return 0
    if not args.parent:
        ap.error('--parent is required')
    trees = {'parent': os.path.abspath(args.parent), 'change': ROOT}
    runs, outs = [], []
    for which in ('parent', 'change', 'change', 'parent'):
        env = dict(os.environ, PYTHONPATH=trees[which])
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--worker',
             '--kernels', args.kernels, '--seed', str(args.seed)]
            + ['--ddim'] * args.ddim,
            env=env, cwd=trees[which], capture_output=True, text=True)
        print('---- %s (%s): rc %d' % (which, trees[which], out.returncode))
        print(out.stdout[-6000:])
        if out.returncode != 0:
            print(out.stderr[-4000:])
            return 1
        outs.append(out.stdout)
        runs.append((which, {c['case']: c for c in map(
            json.loads, (l[5:] for l in out.stdout.splitlines()
                         if l.startswith('CASE ')))}))
    print('case: kernel ms parent, change, change, parent; parent / change; '
          'per output, bits of the change equal to the parent\'s (=) or not '
          '(x)')
    for case in runs[1][1]:
        ms = [r.get(case, {}).get('ms') for _, r in runs]
        ratio = ('%.2fx' % ((ms[0] + ms[3]) / (ms[1] + ms[2]))
                 if None not in ms else 'n/a')
        old = runs[0][1].get(case, {}).get('hashes')
        new = runs[1][1][case].get('hashes')
        bits = ('-' if old is None or new is None or len(old) != len(new)
                else ''.join('=' if a == b else 'x' for a, b in zip(old, new)))
        print('%-70s %s  %s  bits %s  (max abs err %.3e -> %.3e)'
              % (case, ' '.join('%9s' % ('-' if m is None else '%.3f' % m)
                                for m in ms), ratio, bits,
                 runs[0][1].get(case, {}).get('err', float('nan')),
                 runs[1][1][case].get('err', float('nan'))))
    if args.ddim:
        print('fewstep ddim card vs host, parent, change, change, parent: %s'
              % ' '.join(next((l[5:] for l in out.splitlines()
                               if l.startswith('DDIM ')), '-')
                         for out in outs))
    return 0


if __name__ == '__main__':
    sys.exit(main())
