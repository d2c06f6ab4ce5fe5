"""The port's data layer (ucdir_tpu_torch.data, utils.registry, config) on
the CPU against the JAX package's: every dataset kind on the same generated
files and the same seeds of `random` and `np.random` gives the same arrays
bit for bit (both packages run the same numpy, PIL and cv2 code), as do the
masks, the lmdb reader on an environment the JAX package wrote, the dataset
registry and `create_dataset`'s dispatch, and `config.parse` for the three
task configurations."""
import io
import os
import random

import numpy as np
import pytest
from PIL import Image

import ucdir_tpu.config as jax_config
import ucdir_tpu.data as jax_data
from ucdir_tpu.data import mask as jax_mask
from ucdir_tpu.data.lmdb_io import write_lmdb
from ucdir_tpu.utils import registry as jax_registry
import ucdir_tpu_torch.config as port_config
import ucdir_tpu_torch.data as port_data
from ucdir_tpu_torch.data import mask as port_mask
from ucdir_tpu_torch.utils import registry as port_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Generated images: lq/gt pairs (40 x 36), an Imagenet-style folder
    with a txt list (sizes that crop and pad), and LRHR triplet dirs."""
    root = str(tmp_path_factory.mktemp('port_data'))
    g = np.random.default_rng(5)
    for i in range(3):
        for sub in ('lq', 'gt'):
            _save(os.path.join(root, 'pair', sub, '%d.png' % i),
                  g.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    names = []
    for i, (h, w) in enumerate(((45, 50), (70, 33), (24, 30))):
        names.append('img%d.png' % i)
        _save(os.path.join(root, 'imnet', names[-1]),
              g.integers(0, 256, (h, w, 3), dtype=np.uint8))
    with open(os.path.join(root, 'list.txt'), 'w') as f:
        f.write('\n'.join('%s %d' % (n, i) for i, n in enumerate(names)))
    for i in range(3):
        for sub, s in (('lr_16', 16), ('hr_32', 32), ('sr_16_32', 32)):
            _save(os.path.join(root, 'lrhr', sub, '%d.png' % i),
                  g.integers(0, 256, (s, s, 3), dtype=np.uint8))
    return root


def _items(mod, opt, phase, indices=(0, 1, 2), seed=3):
    random.seed(seed), np.random.seed(seed)
    ds = mod.create_dataset(opt, phase)
    return ds, [ds[i] for i in indices]


def _same_items(opt, phase='train', indices=(0, 1, 2)):
    port, got = _items(port_data, opt, phase, indices)
    jax_ds, want = _items(jax_data, opt, phase, indices)
    assert type(port).__name__ == type(jax_ds).__name__
    assert len(port) == len(jax_ds)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
    return got


def _imnet(files, name, split, **args):
    return {'name': 'x', 'datasetname': name, 'data_args': dict(
        dataroot={'root': os.path.join(files, 'imnet'),
                  'txt': os.path.join(files, 'list.txt')},
        split=split, **args)}


@pytest.mark.parametrize('split, args', [
    ('train', {'crop_size': 32, 'factor': [5, 30]}),
    ('train', {'crop_size': 40, 'factor': [20, 20]}),
    ('val', {'crop_size': -1, 'factor': [10, 10]})])
def test_imagenet_jpg_items_equal(files, split, args):
    """The jpg-restore items: the centre crop (upsized when smaller) or the
    /16 crop of full-image validation, and cv2 JPEG at quality `factor`."""
    items = _same_items(_imnet(files, 'ImagenetJPGDataset', split, **args),
                        split)
    if split == 'val':
        assert [it['HR'].shape[:2] for it in items] == [
            (32, 48), (64, 32), (16, 16)]


@pytest.mark.parametrize('name, split', [
    ('ImagenetSRDataset', 'train'), ('ImagenetSRDataset', 'val'),
    ('ImagenetColorDataset', 'train')])
def test_imagenet_sr_and_color_items_equal(files, name, split):
    _same_items(_imnet(files, name, split, crop_size=32), split)


@pytest.mark.parametrize('crop', [0, 24])
def test_single_dataset_items_equal(files, crop):
    _same_items({'name': 'x', 'datasetname': 'SingleDataset', 'data_args': {
        'dataroot': {'gt': os.path.join(files, 'pair', 'gt')},
        'crop_size': crop, 'split': 'train'}})


@pytest.mark.parametrize('mode', ['free_form', 'bbox', 'center',
                                  'irregular', 'hybrid'])
def test_pair_dataset_masks_equal(files, mode):
    """PairDataset's `mask` and `mask_mode` options, and its `datatype`,
    which neither package reads."""
    items = _same_items({'name': 'x', 'datasetname': 'PairDataset',
                         'data_args': {
                             'dataroot': {'lq': os.path.join(files, 'pair',
                                                             'lq'),
                                          'gt': os.path.join(files, 'pair',
                                                             'gt')},
                             'datatype': 'lmdb', 'crop_size': 32,
                             'mask': 1, 'mask_mode': mode}})
    assert items[0]['mask'].shape == (32, 32, 1)


@pytest.mark.parametrize('mode', ['free_form', 'bbox', 'center',
                                  'irregular', 'hybrid'])
def test_masks_equal(mode):
    for shape in ((256, 256), (96, 128)):
        np.random.seed(7)
        want = jax_mask.get_mask(mode, shape)
        np.random.seed(7)
        got = port_mask.get_mask(mode, shape)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match='nope'):
        port_mask.get_mask('nope', (8, 8))


@pytest.mark.parametrize('need_lr', [False, True])
def test_lrhr_dataset_img_items_equal(files, need_lr):
    """The LRHRDataset fallback (no datasetname) on triplet dirs."""
    opt = {'name': 'x', 'dataroot': os.path.join(files, 'lrhr'),
           'l_resolution': 16, 'r_resolution': 32,
           'mode': 'LRHR' if need_lr else 'HR'}
    items = _same_items(opt, 'train')
    assert ('LR' in items[0]) == need_lr


def _encode(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='PNG')
    return buf.getvalue()


@pytest.mark.parametrize('need_lr', [False, True])
def test_lrhr_dataset_reads_the_jax_packages_lmdb(tmp_path, need_lr):
    """An lmdb environment written by the JAX package's `write_lmdb` (keys
    of the reference's schema, PNG values, some above the inline limit)
    gives the port's LRHRDataset the JAX package's items."""
    g = np.random.default_rng(2)
    entries = [('length', '3')]
    for i in range(3):
        k = str(i).zfill(5)
        entries += [('lr_16_' + k, _encode(g.integers(0, 256, (16, 16, 3),
                                                      dtype=np.uint8))),
                    ('hr_32_' + k, _encode(g.integers(0, 256, (32, 32, 3),
                                                      dtype=np.uint8))),
                    ('sr_16_32_' + k, _encode(g.integers(
                        0, 256, (32, 32, 3), dtype=np.uint8)))]
    env = str(tmp_path / 'env')
    write_lmdb(env, entries, inline_max=256)
    opt = {'name': 'x', 'dataroot': env, 'datatype': 'lmdb',
           'l_resolution': 16, 'r_resolution': 32,
           'mode': 'LRHR' if need_lr else 'HR'}
    for phase in ('train', 'val'):
        items = _same_items(opt, phase)
    assert items[2]['HR'].shape == (32, 32, 3)


def test_lmdb_reader_scans_what_the_jax_writer_wrote(tmp_path):
    from ucdir_tpu_torch.data.lmdb_io import LmdbReader
    items = {('k%04d' % i) * 20: bytes([i % 251]) * (i * 7)
             for i in range(400)}
    write_lmdb(str(tmp_path), items)
    with LmdbReader(str(tmp_path)) as r:
        assert len(r) == len(items)
        assert {bytes(k).decode(): bytes(v) for k, v in r.items()} == items
        assert r.get(next(iter(items))) == items[next(iter(items))]
        assert r.get('missing') is None


def test_registry_and_create_dataset_dispatch(files):
    """A registered name builds the registered class; an unknown name
    raises the JAX registry's KeyError; RealESRGANDataset comes from
    realsr.py; no datasetname is LRHRDataset."""
    for reg in (jax_registry, port_registry):
        with pytest.raises(KeyError, match="No object named 'NoSuchSet' "
                                           "found in 'dataset' registry"):
            reg.DATASET_REGISTRY.get('NoSuchSet')
    with pytest.raises(KeyError, match="No object named 'NoSuchSet'"):
        port_data.create_dataset({'datasetname': 'NoSuchSet',
                                  'data_args': {}}, 'train')

    reg = port_registry.Registry('dataset')

    @reg.register()
    class Mine:
        def __init__(self, **kw):
            self.kw = kw
    assert reg.get('Mine') is Mine and 'Mine' in reg
    with pytest.raises(AssertionError, match='already registered'):
        reg.register(Mine)

    name = 'PortDispatchProbe'
    if name not in port_registry.DATASET_REGISTRY:
        port_registry.DATASET_REGISTRY.register(
            type(name, (), {'__init__': lambda self, **kw: None}))
    assert type(port_data.create_dataset(
        {'datasetname': name, 'data_args': {'a': 1}}, 'train')).__name__ \
        == name

    from ucdir_tpu_torch.realsr import RealESRGANDataset
    ds = port_data.create_dataset(_imnet(files, 'RealESRGANDataset', 'train',
                                         crop_size=32), 'train')
    assert type(ds) is RealESRGANDataset
    ds = port_data.create_dataset({'dataroot': os.path.join(files, 'lrhr'),
                                   'l_resolution': 16, 'r_resolution': 32},
                                  'val')
    assert type(ds) is port_data.LRHRDataset and len(ds) == 3


@pytest.mark.parametrize('task', ['sid', 'gop-deblur', 'jpg-restore'])
@pytest.mark.parametrize('phase, kw', [
    ('train', {}), ('val', {'checkpoint': 'x'}), ('train', {'debug': True}),
    ('val', {'checkpoint': 'x', 'debug': True})])
def test_config_parse_matches_for_the_tasks(monkeypatch, task, phase, kw):
    monkeypatch.setattr(jax_config, 'get_timestamp', lambda: 'T')
    monkeypatch.setattr(port_config, 'get_timestamp', lambda: 'T')
    monkeypatch.setenv('UCDIR_TPU_GOPRO_TEST_ROOT', '/gopro/test')
    monkeypatch.setenv('UCDIR_TPU_IMAGENET_VAL_TXT', '/imnet/val.txt')
    path = os.path.join(ROOT, 'ucdir_tpu', 'configs', task + '.yaml')
    got = port_config.parse(path, phase=phase, num_processes=1,
                            make_dirs=False, **kw)
    assert got == jax_config.parse(path, phase=phase, num_processes=1,
                                   make_dirs=False, **kw)
    if phase == 'val':
        sched = got['model']['beta_schedule']['val']
        assert (sched['n_timestep'], sched['linear_end']) == (
            10 if kw.get('debug') else 50, 0.4)


def test_importing_the_data_layer_loads_neither_pil_nor_cv2():
    import subprocess
    import sys
    code = ('import sys\n'
            'import ucdir_tpu_torch.data, ucdir_tpu_torch.realsr\n'
            'import ucdir_tpu_torch.data.mask, ucdir_tpu_torch.data.lmdb_io\n'
            'bad = sorted(k for k in sys.modules if k.split(".")[0] in\n'
            '             ("PIL", "cv2", "jax", "ucdir_tpu"))\n'
            'assert not bad, bad\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize('lmdb', [False, True])
def test_prepare_data_writes_what_the_jax_tool_writes(files, tmp_path, lmdb):
    """prepare_data's lr/hr/sr directories, or its lmdb environment, from
    the same source images: the same files byte for byte; the port's
    LRHRDataset then reads them."""
    from ucdir_tpu.data import prepare_data as theirs
    from ucdir_tpu_torch.data import prepare_data as ours
    src = os.path.join(files, 'imnet')
    fn = 'prepare_lmdb' if lmdb else 'prepare'
    for mod, out in ((theirs, 'jax'), (ours, 'port')):
        getattr(mod, fn)(src, str(tmp_path / out), sizes=(8, 16), n_worker=1)
    written = {}
    for out in ('jax', 'port'):
        root = str(tmp_path / out)
        written[out] = {os.path.relpath(os.path.join(d, f), root):
                        open(os.path.join(d, f), 'rb').read()
                        for d, _, fs in os.walk(root) for f in fs}
    assert written['port'] == written['jax'] and len(written['port']) in (
        1, 9)
    ds = port_data.create_dataset({
        'dataroot': str(tmp_path / 'port'), 'l_resolution': 8,
        'r_resolution': 16, 'datatype': 'lmdb' if lmdb else 'img',
        'mode': 'LRHR'}, 'val')
    assert len(ds) == 3 and ds[1]['LR'].shape == (8, 8, 3)
