#!/usr/bin/env python3
"""Times the port's kernels from two trees in one process group on one card.

    python3 tools/torch_kernel_ab.py --parent DIR [--kernels conv3x3,conv1x1]

DIR holds another checkout of the repository (for example `git archive` of
the parent commit, unpacked into a directory that .gitignore lists). The
cases and the timing are those of phase 2 of this tree's chip_smoke.py
(`kernel_cases`, `timed`); only the
package `ucdir_tpu_torch` (and so the kernels' sources) comes from the tree
under test. The trees run in turns, parent, change, change, parent, each in a
process of its own that builds its kernels, so that a drift of the card
between calls cannot pass for a difference between the trees. Prints each
run's lines, then one line per case with the four times.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(kernels, seed):
    """The cases of chip_smoke.py's phase 2 for `kernels`, on the
    `ucdir_tpu_torch` that sys.path gives; prints 'CASE <json>' per case."""
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
        got = chip_smoke.flat(case['kernel']())[0]
        err = (got - chip_smoke.flat(case['plain']())[0]).abs().max().item()
        del got
        print('CASE ' + json.dumps({
            'case': '%s %s' % (case['name'], case['label']),
            'ms': chip_smoke.timed(case['kernel'], 5), 'err': err}),
            flush=True)
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', help='root of the other checkout')
    ap.add_argument('--kernels', default='conv3x3,conv1x1,conv3x3_preact')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--worker', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kernels = tuple(args.kernels.split(','))
    if args.worker:
        worker(kernels, args.seed)
        return 0
    if not args.parent:
        ap.error('--parent is required')
    trees = {'parent': os.path.abspath(args.parent), 'change': ROOT}
    runs = []
    for which in ('parent', 'change', 'change', 'parent'):
        env = dict(os.environ, PYTHONPATH=trees[which])
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--worker',
             '--kernels', args.kernels, '--seed', str(args.seed)],
            env=env, cwd=trees[which], capture_output=True, text=True)
        print('---- %s (%s): rc %d' % (which, trees[which], out.returncode))
        print(out.stdout[-6000:])
        if out.returncode != 0:
            print(out.stderr[-4000:])
            return 1
        runs.append((which, {c['case']: c for c in map(
            json.loads, (l[5:] for l in out.stdout.splitlines()
                         if l.startswith('CASE ')))}))
    print('case: kernel ms parent, change, change, parent; parent / change')
    for case in runs[1][1]:
        ms = [r.get(case, {}).get('ms') for _, r in runs]
        ratio = ('%.2fx' % ((ms[0] + ms[3]) / (ms[1] + ms[2]))
                 if None not in ms else 'n/a')
        print('%-70s %s  %s  (max abs err %.3e -> %.3e)'
              % (case, ' '.join('%9s' % ('-' if m is None else '%.3f' % m)
                                for m in ms), ratio,
                 runs[0][1].get(case, {}).get('err', float('nan')),
                 runs[1][1][case]['err']))
    return 0


if __name__ == '__main__':
    sys.exit(main())
