"""The port's evaluator (`python -m ucdir_tpu_torch.eval1`) and its metrics
against the JAX package's, on the CPU.

Inception: the port's `InceptionV3Features` against the JAX one on the same
random weights (a pytorch-fid layout state dict with random BatchNorm
statistics, converted by the JAX package's `convert_inception_torch` and
carried to the port by `inception_from_jax`): 2 images, pool3 features
within 1e-4 of the largest (both add float32 convolutions in their own
orders), and the softmax of the logits through the fc head within 1e-4 of
the largest probability. `preprocess` against the JAX one at an upscaled
and a downscaled size: within 1e-6 (both interpolate in float32).

FID, KID, IS, the patch grid and NIQE are the JAX package's numpy and scipy
code, copied: on the same inputs equal to 1e-6 rel.

CLI: two generated 256 x 256 pairs, random LPIPS and Inception weight files
as tests/test_eval1_e2e.py makes them; the port's `-s <dir> --device cpu`
prints the root evaluator's metric lines, PSNR, SSIM and NIQE to 1e-6 rel,
LPIPS and FID to 1e-4 rel (readings 9e-7 and 2.4e-6), KID within 1e-6 of
the size of its kernel sums (reading 9e-8: over two patches a side they
cancel to 3e-6 of their size, and in float32 they round at about 1e-7 of
it), and afterwards sys.modules holds nothing of
ucdir_tpu, jax, jaxlib, flax, optax or orbax. Without weights it prints the
skips, and without `--device cpu` on a host with no card it raises.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucdir_tpu.metrics import fid as jfid
from ucdir_tpu.metrics import inception as jinc
from ucdir_tpu.metrics import niqe as jniqe
from ucdir_tpu_torch.metrics import fid, inception, niqe
from ucdir_tpu_torch.utils.convert_jax import inception_from_jax

from test_feature_oracles import TorchFIDInception, _random_lpips_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_inception(seed, fc=False):
    """A pytorch-fid layout state dict with random weights and BatchNorm
    statistics (and a random fc head). The convolutions' weights are drawn
    at He's scale, so that the features keep their size through the 94
    layers and differ between images (at PyTorch's default scale they
    shrink to about 1e-7 and are all but equal)."""
    torch.manual_seed(seed)
    net = TorchFIDInception()
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.kaiming_normal_(m.weight)
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 1.5)
    sd = dict(net.state_dict())
    if fc:
        head = torch.nn.Linear(2048, 1000)
        sd['fc.weight'], sd['fc.bias'] = head.weight.detach(), \
            head.bias.detach()
    return sd


def test_inception_features_and_probs_match_jax(rng):
    params = jinc.convert_inception_torch(random_inception(0, fc=True))
    images = rng.integers(0, 256, (2, 96, 112, 3), dtype=np.uint8)
    feat = {k: v for k, v in params.items() if k != 'fc'}
    want = np.asarray(jax.jit(lambda z: jinc.InceptionV3Features().apply(
        {'params': feat}, z))(jinc.preprocess(images)))
    sd = inception_from_jax(params)
    model = inception.InceptionV3Features()
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith('fc.')})
    with torch.no_grad():
        got = model(inception.preprocess(images)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    want_p = jinc.inception_probs(params, images)
    got_p = inception.inception_probs(sd, images, device='cpu')
    assert got_p.shape == want_p.shape == (2, 1000)
    assert np.abs(got_p - want_p).max() <= 1e-4 * want_p.max()


def test_weight_files_load_as_the_jax_package_loads_them(rng, tmp_path):
    """A pytorch-fid/torchvision .pth and the JAX package's .npz of the same
    weights: the port's classifier and feature functions against the JAX
    package's on each."""
    sd = random_inception(1, fc=True)
    pth = str(tmp_path / 'inception.pth')
    torch.save(sd, pth)
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat['/'.join(path + (k,))] = v
    walk(jinc.convert_inception_torch(sd), ())
    npz = str(tmp_path / 'inception.npz')
    np.savez(npz, **flat)
    images = rng.integers(0, 256, (3, 80, 72, 3), dtype=np.uint8)
    want_p = jinc.make_classifier_fn(pth, batch_size=2)(images)
    want_f = jinc.make_feature_fn(pth, batch_size=2)(images)
    for path in (pth, npz):
        got_p = inception.make_classifier_fn(path, 2, device='cpu')(images)
        got_f = inception.make_feature_fn(path, 2, device='cpu')(images)
        assert got_p.shape == (3, 1000) and got_f.shape == (3, 2048)
        assert np.abs(got_p - want_p).max() <= 1e-4 * want_p.max()
        assert np.abs(got_f - want_f).max() <= 1e-4 * np.abs(want_f).max()


@pytest.mark.parametrize('size', [(2, 256, 200), (1, 320, 360)])
def test_preprocess_matches_jax(rng, size):
    images = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    want = np.asarray(jinc.preprocess(images))
    got = inception.preprocess(images).numpy()
    assert got.shape == want.shape == (size[0], 299, 299, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    floats = images / 255.
    np.testing.assert_allclose(inception.preprocess(floats).numpy(),
                               np.asarray(jinc.preprocess(floats)),
                               atol=1e-6, rtol=0)


def test_fid_kid_is_and_patches_match_jax(rng):
    f1 = rng.standard_normal((40, 16))
    f2 = rng.standard_normal((32, 16)) * 1.1 + 0.2
    for name in ('fid_from_features', 'kid_from_features'):
        np.testing.assert_allclose(getattr(fid, name)(f1, f2),
                                   getattr(jfid, name)(f1, f2), rtol=1e-6)
    probs = rng.dirichlet(np.ones(10), size=50)
    np.testing.assert_allclose(fid.inception_score(probs),
                               jfid.inception_score(probs), rtol=1e-6)
    img = rng.integers(0, 256, (600, 520, 3), dtype=np.uint8)
    got = fid.patch_decompose(img, 256)
    assert got.shape == (4, 256, 256, 3)
    np.testing.assert_array_equal(got, jfid.patch_decompose(img, 256))
    assert fid.patch_decompose(img[:100], 256).shape == (0, 256, 256, 3)


def test_niqe_matches_jax(rng):
    yy, xx = np.mgrid[:200, :240]
    smooth = 128 + 60 * np.sin(yy / 9.) * np.cos(xx / 13.)
    images = [
        np.clip(smooth[..., None] + rng.normal(0, s, (200, 240, 3)), 0,
                255).astype(np.uint8) for s in (4., 12.)]
    images.append(rng.integers(0, 256, (130, 150, 3), dtype=np.uint8))
    for img in images:
        for bgr in (False, True):
            np.testing.assert_allclose(
                niqe.calculate_niqe(img, 0, bgr=bgr),
                jniqe.calculate_niqe(img, 0, bgr=bgr), rtol=1e-6)


@pytest.fixture(scope='module')
def results_dir(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp('eval1') / 'results'
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        hr = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        sr = np.clip(hr.astype(int) + rng.normal(0, 12, hr.shape),
                     0, 255).astype(np.uint8)
        cv2.imwrite(str(d / f'{i}_x_hr.png'), hr)
        cv2.imwrite(str(d / f'{i}_x_sr.png'), sr)
    return str(d)


@pytest.fixture(scope='module')
def weight_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('weights')
    lpips_path = str(tmp / 'lpips_alex.pth')
    torch.save(_random_lpips_state_dict(torch.Generator().manual_seed(0)),
               lpips_path)
    inc_path = str(tmp / 'inception_fid.pth')
    torch.save(random_inception(0), inc_path)
    return lpips_path, inc_path


# the port's evaluator in a process of its own; afterwards nothing of JAX
# or of the JAX package was imported
_CLI = (
    'import sys\n'
    'from ucdir_tpu_torch import eval1\n'
    'eval1.main(sys.argv[1:])\n'
    'bad = sorted(k for k in sys.modules if k.split(".")[0] in\n'
    '             ("ucdir_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))\n'
    'assert not bad, bad\n')


def port_cli(*args, **env):
    clean = {k: v for k, v in os.environ.items()
             if k not in ('UCDIR_TPU_LPIPS_WEIGHTS',
                          'UCDIR_TPU_INCEPTION_NPZ')}
    return subprocess.run(
        [sys.executable, '-c', _CLI, *args], capture_output=True, text=True,
        timeout=600, env=dict(clean, PYTHONPATH=ROOT, OMP_NUM_THREADS='2',
                              **env))


def metric_lines(out):
    """{'LPIPS': x, 'PSNR': x, 'SSIM': x, 'niqe': x, 'FID:': x, 'KID': x}
    of an evaluator's printed lines."""
    keys = ('LPIPS', 'PSNR', 'SSIM', 'niqe', 'FID:', 'KID')
    return {w[0]: float(w[1]) for w in map(str.split, out.splitlines())
            if len(w) == 2 and w[0] in keys}


def test_eval1_cli_matches_root_evaluator(results_dir, weight_files,
                                          monkeypatch, capsys):
    lpips_path, inc_path = weight_files
    monkeypatch.setenv('UCDIR_TPU_LPIPS_WEIGHTS', lpips_path)
    monkeypatch.setenv('UCDIR_TPU_INCEPTION_NPZ', inc_path)
    monkeypatch.setattr(sys, 'argv', ['eval1.py', '-s', results_dir])
    monkeypatch.syspath_prepend(ROOT)
    import eval1
    eval1.main()
    want = metric_lines(capsys.readouterr().out)
    proc = port_cli('-s', results_dir, '--device', 'cpu',
                    UCDIR_TPU_LPIPS_WEIGHTS=lpips_path,
                    UCDIR_TPU_INCEPTION_NPZ=inc_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'skipped' not in proc.stdout, proc.stdout
    got = metric_lines(proc.stdout)
    assert got.keys() == want.keys() == {'LPIPS', 'PSNR', 'SSIM', 'niqe',
                                         'FID:', 'KID'}, (got, want)
    for key in ('LPIPS', 'PSNR', 'SSIM', 'niqe', 'FID:'):
        tol = 1e-6 if key in ('PSNR', 'SSIM', 'niqe') else 1e-4
        np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                   err_msg=key)
    # KID over two patches a side: the cubic kernel's sums of float32
    # features cancel to a value 3e-6 of their size, and they round at about
    # 1e-7 of it; held within 1e-6 of that size
    f1, f2 = (fid.inception_features(load_patches(results_dir + suffix),
                                     inc_path, device='cpu')
              for suffix in ('_gt_pt', '_sr_pt'))
    n, m = f1.shape[1], len(f1)
    size = (((f2 @ f2.T / n + 1) ** 3 + (f1 @ f1.T / n + 1) ** 3).sum()
            / (m - 1) + ((f2 @ f1.T / n + 1) ** 3).sum() * 2 / m) / m
    assert abs(got['KID'] - want['KID']) <= 1e-6 * size, (got, want, size)
    assert len(os.listdir(results_dir + '_sr_pt')) == 2


def load_patches(path):
    import cv2
    return np.stack([cv2.imread(os.path.join(path, f))
                     for f in sorted(os.listdir(path))])


def test_eval1_without_weights_reports_skips_and_needs_a_device(results_dir):
    proc = port_cli('-s', results_dir, '--device', 'cpu')
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'LPIPS skipped' in proc.stdout
    assert 'FID/KID skipped' in proc.stdout
    assert set(metric_lines(proc.stdout)) == {'PSNR', 'SSIM', 'niqe'}
    if not torch.cuda.is_available():
        proc = port_cli('-s', results_dir)
        assert proc.returncode != 0
        assert 'CUDA is unavailable' in proc.stderr
