"""The port's logging and small utilities on the CPU: `utils/color.py`
against the JAX package's, `utils/profiler.py`, `data/prefetcher.py`, and
the command line's TensorBoard and W&B logging (`-enable_wandb` without the
wandb package: a warning, and training goes on).

Tolerances: the color conversions 1e-6 abs where the values are of order 1
(sRGB, linear, XYZ, YUV) and 1e-6 relative in Lab (L up to 100, float32 on
both sides).
"""
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from ucdir_tpu.utils import color as jax_color
from ucdir_tpu_torch.data.prefetcher import CPUPrefetcher, DevicePrefetcher
from ucdir_tpu_torch.utils import color, profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
from test_torch_port_train import _CLI, _tiny_yaml  # noqa: E402

torch.set_num_threads(2)

# (function, input kind): 'rgb' in [0, 1], 'lab' from rgb_to_lab
COLOR_FNS = [('srgb_to_linear', 'rgb'), ('linear_to_srgb', 'rgb'),
             ('rgb_to_xyz', 'rgb'), ('xyz_to_rgb', 'rgb'),
             ('xyz_to_lab', 'rgb'), ('lab_to_xyz', 'lab'),
             ('rgb_to_lab', 'rgb'), ('lab_to_rgb', 'lab'),
             ('rgb_to_yuv', 'rgb'), ('yuv_to_rgb', 'rgb')]


@pytest.mark.parametrize('name,kind', COLOR_FNS)
def test_color_matches_jax(rng, name, kind):
    rgb = rng.uniform(0, 1, (4, 9, 7, 3)).astype(np.float32)
    rgb[0, 0, :3] = [[0., 0., 0.], [1., 1., 1.], [0.01, 0.002, 0.5]]
    x = (np.asarray(jax_color.rgb_to_lab(jnp.asarray(rgb))) if kind == 'lab'
         else rgb)
    want = np.asarray(getattr(jax_color, name)(jnp.asarray(x)))
    got = getattr(color, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    lab_out = name.endswith('_lab')
    np.testing.assert_allclose(got.numpy(), want,
                               rtol=1e-6 if lab_out else 0,
                               atol=1e-4 if lab_out else 1e-6)


def test_color_roundtrips(rng):
    rgb = torch.from_numpy(rng.uniform(0, 1, (16, 3)).astype(np.float32))
    assert (color.lab_to_rgb(color.rgb_to_lab(rgb)) - rgb).abs().max() < 1e-4
    # the two published matrices are inverses to about 2e-5
    assert (color.yuv_to_rgb(color.rgb_to_yuv(rgb)) - rgb).abs().max() < 1e-4
    gray = torch.full((5, 3), 0.4)
    assert color.rgb_to_yuv(gray)[..., 1:].abs().max() < 1e-5


def test_step_timer():
    t = profiler.StepTimer(alpha=1.0)
    assert t.steps_per_sec == 0.0
    with t:
        time.sleep(0.01)
    assert t.avg >= 0.01 and t.steps_per_sec > 0
    first = t.avg
    t.alpha = 0.5
    with t:
        pass
    assert t.avg < first


def test_profiler_trace_writes_a_trace(tmp_path):
    """trace() writes a Chrome trace holding an annotated region and the
    ops inside it."""
    with profiler.trace(str(tmp_path / 'prof')):
        with profiler.annotate('resident_step'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / 'prof' / 'trace.json'
    text = path.read_text()
    assert 'resident_step' in text and 'aten::mm' in text


def test_prefetcher_keeps_order_and_depth():
    """Batches come out in order, arrays as tensors; `depth` batches are
    taken from the loader before the first comes out, one more per batch
    handed out."""
    taken = []

    def loader():
        for i in range(5):
            taken.append(i)
            yield {'x': np.full((2, 2), i, np.float32), 'name': 'b%d' % i}

    class Loader:
        def __iter__(self):
            return loader()

        def __len__(self):
            return 5

    pre = DevicePrefetcher(Loader(), device='cpu', depth=3)
    assert len(pre) == 5
    out = []
    for b in pre:
        assert torch.is_tensor(b['x'])
        out.append((float(b['x'][0, 0]), b['name'], len(taken)))
    assert out == [(0., 'b0', 4), (1., 'b1', 5), (2., 'b2', 5),
                   (3., 'b3', 5), (4., 'b4', 5)]
    assert list(CPUPrefetcher([1, 2])) == [1, 2]


def _events(path):
    """The (tag, step, value) scalars of a TensorBoard event file (TFRecord
    framing: length, its CRC, the Event proto, its CRC)."""
    from tensorboardX.proto import event_pb2
    out = []
    with open(path, 'rb') as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            (n,) = struct.unpack('<Q', head[:8])
            event = event_pb2.Event.FromString(f.read(n))
            f.read(4)
            for v in event.summary.value:
                out.append((v.tag, event.step,
                            v.simple_value if v.HasField('simple_value')
                            else None))
    return out


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    """`sr.main -p train -enable_wandb -log_wandb_ckpt` on the toy config
    with a `tile` dict: batch 2, 4 steps, printing and validating (2 steps
    of the val schedule) every 2, saving at 4; in a process that fails if
    anything of JAX or of the JAX package was imported."""
    tmp = tmp_path_factory.mktemp('cli_logging')
    _tiny_yaml(tmp)
    cfg = yaml.safe_load((tmp / 'tiny.yaml').read_text())
    cfg['tile'] = {'skip': 128, 'padding': 16}
    cfg['datasets']['train']['batch_size'] = 2
    cfg['train'].update(print_freq=2, val_freq=2, save_checkpoint_freq=4)
    cfg['model']['beta_schedule']['val']['n_timestep'] = 2
    (tmp / 'tiny.yaml').write_text(yaml.safe_dump(cfg))
    proc = subprocess.run(
        [sys.executable, '-c', _CLI, '-p', 'train', '-c', 'tiny.yaml',
         '--device', 'cpu', '-enable_wandb', '-log_wandb_ckpt'], cwd=tmp,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp, proc.stderr


def test_cli_enable_wandb_warns_and_trains_on(cli_run):
    """wandb is not installed: one warning, then the run trains, validates
    (the 40 x 40 pairs tiled, 168 x 168 after the pad above the 128-px
    tiles) and saves."""
    tmp, log = cli_run
    assert log.count('wandb unavailable') == 1
    assert log.count('l_pix: ') == 2
    assert log.count('# Validation # PSNR: ') == 2
    assert 'End of training.' in log
    assert any(f == 'I_Elatest_gen.pth' for _, _, fs in os.walk(tmp)
               for f in fs)


def test_cli_tensorboard_scalars_and_images(cli_run):
    """The train run's event file holds l_pix at steps 2 and 4, psnr at the
    same steps, and one image row per validation image and validation."""
    pytest.importorskip('tensorboardX')
    tmp, _ = cli_run
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp) for f in fs
             if f.startswith('events.out.tfevents')]
    scalars = [e for path in files for e in _events(path)]
    by_tag = {}
    for tag, step, value in scalars:
        by_tag.setdefault(tag, []).append((step, value))
    assert [s for s, _ in by_tag['l_pix']] == [2, 4]
    assert [s for s, _ in by_tag['psnr']] == [2, 4]
    assert all(np.isfinite(v) for _, v in by_tag['l_pix'] + by_tag['psnr'])
    images = [t for t in by_tag if t.startswith('Iter_')]
    assert sorted(images) == ['Iter_2', 'Iter_4']
    assert all(len(by_tag[t]) == 2 for t in images)
