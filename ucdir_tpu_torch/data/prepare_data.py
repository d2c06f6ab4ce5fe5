"""Dataset preparation tool — resize an image folder into lr/hr/sr PNG dirs
or an LMDB environment. Counterpart of `ucdir_tpu/data/prepare_data.py` (the
port keeps its own copy); it writes LRHRDataset's directories.

Parity target: data/prepare_data.py:100-183 (multiprocess
resize into `{out}_{lr}_{hr}/{lr_N,hr_M,sr_N_M}` directory triplets, or with
`--lmdb` a single LMDB file with the reference key schema
lr_{N}_{i:05d}/hr_{M}_{i:05d}/sr_{N}_{M}_{i:05d} + 'length' — written by the
pure-Python lmdb_io.write_lmdb, no `lmdb` package needed).

    python -m ucdir_tpu_torch.data.prepare_data --path <imgs> --out <dir> --size 64,512 [--lmdb]
"""
from __future__ import annotations

import argparse
import os
from multiprocessing import Pool

from PIL import Image

from ucdir_tpu_torch.data.util import get_paths_from_images


def resize_and_convert(img: Image.Image, size: int,
                       resample=Image.BICUBIC) -> Image.Image:
    if img.size[0] != size:
        img = img.resize((size, size), resample)
    return img


def resize_worker(args):
    path, sizes, out_dir = args
    lr_size, hr_size = sizes
    name = os.path.splitext(os.path.basename(path))[0]
    img = Image.open(path).convert('RGB')
    # center crop to square
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2,
                    (w - s) // 2 + s, (h - s) // 2 + s))
    hr = resize_and_convert(img, hr_size)
    lr = resize_and_convert(img, lr_size)
    sr = resize_and_convert(lr, hr_size)
    hr.save(os.path.join(out_dir, f'hr_{hr_size}', f'{name}.png'))
    lr.save(os.path.join(out_dir, f'lr_{lr_size}', f'{name}.png'))
    sr.save(os.path.join(out_dir, f'sr_{lr_size}_{hr_size}', f'{name}.png'))
    return name


def lmdb_worker(args):
    """One source image -> the three encoded-PNG lmdb entries."""
    import io
    path, sizes, idx = args
    lr_size, hr_size = sizes
    img = Image.open(path).convert('RGB')
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2,
                    (w - s) // 2 + s, (h - s) // 2 + s))
    hr = resize_and_convert(img, hr_size)
    lr = resize_and_convert(img, lr_size)
    sr = resize_and_convert(lr, hr_size)

    def enc(im):
        buf = io.BytesIO()
        im.save(buf, format='PNG')
        return buf.getvalue()

    i = str(idx).zfill(5)
    return [('lr_{}_{}'.format(lr_size, i), enc(lr)),
            ('hr_{}_{}'.format(hr_size, i), enc(hr)),
            ('sr_{}_{}_{}'.format(lr_size, hr_size, i), enc(sr))]


def prepare_lmdb(img_path: str, out_path: str, sizes=(64, 512),
                 n_worker: int = 4):
    """Reference prepare_data.py:81-92 lmdb_save mode, keys incl. 'length'."""
    from ucdir_tpu_torch.data.lmdb_io import write_lmdb
    files = get_paths_from_images(img_path)
    jobs = [(f, sizes, i) for i, f in enumerate(files)]
    entries = [('length', str(len(files)))]
    if n_worker <= 1:
        groups = [lmdb_worker(j) for j in jobs]
    else:
        with Pool(n_worker) as pool:
            groups = list(pool.imap(lmdb_worker, jobs))
    for g in groups:
        entries.extend(g)
    out = write_lmdb(out_path, entries)
    print('done:', len(files), '->', out)


def prepare(img_path: str, out_path: str, sizes=(64, 512), n_worker: int = 4):
    lr, hr = sizes
    for sub in (f'lr_{lr}', f'hr_{hr}', f'sr_{lr}_{hr}'):
        os.makedirs(os.path.join(out_path, sub), exist_ok=True)
    files = get_paths_from_images(img_path)
    jobs = [(f, sizes, out_path) for f in files]
    if n_worker <= 1:
        for j in jobs:
            resize_worker(j)
    else:
        with Pool(n_worker) as pool:
            for i, _ in enumerate(pool.imap_unordered(resize_worker, jobs)):
                if i % 100 == 0:
                    print(f'{i}/{len(jobs)}')
    print('done:', len(jobs))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--path', '-p', type=str, required=True)
    parser.add_argument('--out', '-o', type=str, required=True)
    parser.add_argument('--size', '-s', type=str, default='64,512')
    parser.add_argument('--n_worker', '-n', type=int, default=4)
    parser.add_argument('--lmdb', '-l', action='store_true',
                        help='write one LMDB env instead of PNG dirs')
    args = parser.parse_args()
    sizes = [int(s.strip()) for s in args.size.split(',')]
    fn = prepare_lmdb if args.lmdb else prepare
    fn(args.path, args.out, sizes=tuple(sizes), n_worker=args.n_worker)


if __name__ == '__main__':
    main()
