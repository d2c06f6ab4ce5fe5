"""The offline evaluator, CLI-compatible with the root `eval1.py` (the
reference's eval1.py:180-251):

    python -m ucdir_tpu_torch.eval1 -s <results_dir> [--device cuda|cpu]

Per pair of `*hr*` / `*sr*` images in a results directory: LPIPS (alex),
PSNR, SSIM and NIQE; then the 256-px patch folders `<dir>_gt_pt` and
`<dir>_sr_pt`, and FID and KID over the two patch sets. It prints the lines
the root evaluator prints.

LPIPS and the Inception features run on `--device`, CUDA by default (CUDA
with no card raises: nothing falls back to the CPU), on weights the user
supplies (`UCDIR_TPU_LPIPS_WEIGHTS`, `UCDIR_TPU_INCEPTION_NPZ`); without
them each is reported as skipped. PSNR, SSIM and NIQE are numpy on the
host and always run. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def compare_psnr(img1, img2, data_range=255):
    """skimage.metrics.peak_signal_noise_ratio, in float64."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float('inf')
    return float(10 * np.log10((data_range ** 2) / mse))


def main(argv=None):
    import cv2
    from ucdir_tpu_torch.metrics.fid import patch_decompose
    from ucdir_tpu_torch.metrics.niqe import calculate_niqe
    from ucdir_tpu_torch.metrics.ssim import calculate_ssim

    parser = argparse.ArgumentParser()
    parser.add_argument('-s', '--src', type=str, required=True,
                        help='results directory with *hr*/*sr* images')
    parser.add_argument('-fid', type=float, default=0)
    parser.add_argument('--device', default='cuda',
                        help='where LPIPS and Inception run: cuda (default) '
                             'or cpu')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but CUDA is unavailable; pass '
                           '--device cpu to run on the CPU')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    gtdata = sorted(os.path.join(args.src, f) for f in os.listdir(args.src)
                    if 'hr' in f)
    outdata = sorted(os.path.join(args.src, f) for f in os.listdir(args.src)
                     if 'sr' in f)
    assert len(gtdata) == len(outdata), (len(gtdata), len(outdata))
    print('start', len(gtdata), 'pairs')

    lpips_fn = None
    try:
        from ucdir_tpu_torch.metrics.lpips import make_lpips
        lpips_fn = make_lpips()
    except RuntimeError as e:
        print('LPIPS skipped:', e)

    res = []
    for idx, item in enumerate(gtdata):
        print('%2d/%d %s %s' % (idx, len(gtdata), item, outdata[idx]))
        gt = cv2.imread(gtdata[idx])       # BGR
        output = cv2.imread(outdata[idx])  # BGR
        lp = np.nan
        if lpips_fn is not None:
            a = output[:, :, ::-1].astype(np.float32) / 127.5 - 1.
            b = gt[:, :, ::-1].astype(np.float32) / 127.5 - 1.
            with torch.no_grad():
                lp = float(lpips_fn(torch.from_numpy(a[None]).to(device),
                                    torch.from_numpy(b[None]).to(device))[0])
        res.append([
            lp,
            compare_psnr(output, gt, data_range=255),
            calculate_ssim(output, gt, 0),
            calculate_niqe(output, 0, input_order='HWC', convert_to='y',
                           bgr=True),
        ])

    res = np.array(res)
    if lpips_fn is not None:
        print('LPIPS', np.nanmean(res[:, 0]))
    print('PSNR', np.mean(res[:, 1]))
    print('SSIM', np.mean(res[:, 2]))
    print('niqe', np.mean(res[:, 3]))

    # 256-px patch decomposition on disk (the reference's eval1.py:222-243)
    path = args.src.rstrip('/')
    gt_save_path, sr_save_path = path + '_gt_pt', path + '_sr_pt'
    for save_path, data in [(gt_save_path, gtdata), (sr_save_path, outdata)]:
        os.makedirs(save_path, exist_ok=True)
        for item in data:
            img = cv2.imread(item)
            for pidx, sub in enumerate(patch_decompose(img, 256)):
                cv2.imwrite(os.path.join(
                    save_path, os.path.basename(item)[:-4] + '%d.png' % pidx),
                    sub)

    try:
        from ucdir_tpu_torch.metrics.fid import (fid_from_features,
                                                 inception_features,
                                                 kid_from_features)

        def load_dir(p):
            files = sorted(os.listdir(p))
            if not files:
                raise RuntimeError('no 256px patches (images smaller than '
                                   'the patch size) — FID/KID undefined')
            return np.stack([cv2.imread(os.path.join(p, f)) for f in files])
        f1 = inception_features(load_dir(gt_save_path), device=device)
        f2 = inception_features(load_dir(sr_save_path), device=device)
        print('FID: {}'.format(fid_from_features(f1, f2)))
        print('KID', kid_from_features(f1, f2))
    except (RuntimeError, NotImplementedError) as e:
        print('FID/KID skipped:', e)


if __name__ == '__main__':
    main()
