"""The port's tile-resident reverse process (ucdir_tpu_torch.parallel.
resident) on the CPU: its geometry against the JAX package's
`ResidentPlan`, the resident path against the port's reassembling one,
against the JAX package's `resident_reverse` and its two-device
`make_eval_step`, and one image's tiles over two gloo ranks (processes of
tests/torch_resident_worker.py) against one process.

Tolerances: the geometry is exact; resident against reassembling, and two
ranks against one process, bit for bit (the same inputs reach every network
call and every update is elementwise); against the JAX package 1e-4 abs,
as tests/test_torch_port_tiled.py holds the tiled path.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ucdir_tpu.models.dy3h import DY3h as JaxDY3h
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.parallel import make_mesh
from ucdir_tpu.parallel import resident as jax_resident
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train.step import make_eval_step
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
from ucdir_tpu_torch.diffusion import sampler as port_sampler
from ucdir_tpu_torch.diffusion.sampler import p_sample_loop
from ucdir_tpu_torch.eval import eval_step
from ucdir_tpu_torch.models.dy3h import DY3h
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.parallel import resident, tiled
from ucdir_tpu_torch.schedule import make_schedule
from ucdir_tpu_torch.utils import convert_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
from test_torch_port_dist import _free_port, _run_ranks  # noqa: E402
from test_torch_port_tiled import GRID_CASES  # noqa: E402
from test_torch_port_train import _CLI, _tiny_yaml  # noqa: E402
from torch_resident_worker import toy_opt  # noqa: E402

torch.set_num_threads(2)

WORKER = os.path.join(ROOT, 'tests', 'torch_resident_worker.py')
SKIP, PADDING = 64, 16
STEPS = 2


@pytest.mark.parametrize('h,w,skip,padding', GRID_CASES)
def test_plan_equals_jax(h, w, skip, padding):
    """Starts, bands, owned rects and every copy (with its flips) equal the
    JAX package's plan; where the canvas is too small for the reflect frame
    both refuse it."""
    try:
        want = jax_resident.ResidentPlan(h, w, skip, padding)
    except AssertionError:
        with pytest.raises(ValueError, match='too small'):
            resident.ResidentPlan(h, w, skip, padding)
        return
    got = resident.ResidentPlan(h, w, skip, padding)
    assert (got.pd, got.H, got.W) == (want.pd, want.H, want.W)
    assert got.starts == want.starts
    assert got.rbands == want.rbands and got.cbands == want.cbands
    assert got.owned == want.owned
    assert [tuple(c) for c in got.copies] == [tuple(c) for c in want.copies]
    for S, starts in ((got.H, got.hs), (got.W, got.ws)):
        assert starts == jax_resident._starts_1d(S, skip, padding)
        assert (resident._owner_intervals(starts, skip, padding)
                == jax_resident._owner_intervals(starts, skip, padding))


def test_full_resolution_plan_owns_every_pixel_once():
    """The 2848 x 4256 frame after the 64-px pad: 24 windows, of which the
    4 that the snapped last column repeats own nothing; the owned rects
    cover the state exactly once."""
    plan = resident.ResidentPlan(2976, 4384, 1024, 64)
    assert plan.n_tiles == 24 and len(plan.owned) == 20
    cover = np.zeros((plan.h, plan.w), np.int32)
    for t in plan.owned:
        r0, r1, c0, c1 = plan.owned_state(t)
        cover[r0:r1, c0:c1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize('h,w,skip,padding', [
    (96, 96, 64, 16), (100, 140, 64, 16), (48, 56, 64, 8),
    (200, 330, 96, 16)])
def test_plan_exchange_rebuilds_every_window(rng, h, w, skip, padding):
    """After arbitrary updates of the owned rects, exchange() gives every
    window its slice of the padded materialized state, and extract ->
    materialize is the identity."""
    plan = resident.ResidentPlan(h, w, skip, padding)
    s = torch.from_numpy(rng.standard_normal((2, h, w, 3))
                         .astype(np.float32))
    tw = plan.extract(s)
    assert torch.equal(plan.materialize(tw), s)

    def upd(t, cur, srect, wrect):
        r0, r1, c0, c1 = srect
        g = (torch.arange(r0, r1)[None, :, None, None] * 1000
             + torch.arange(c0, c1)[None, None, :, None])
        return cur * 0.5 + g.float()

    plan.update_owned(tw, upd)
    want = plan.extract(plan.materialize(tw))
    assert torch.equal(plan.exchange(tw), want)


def _tiny_dy3h():
    cfg = dict(in_channel=6, out_channel=3, inner_channel=8,
               channel_mults=(1, 2), attn_res=(), res_blocks=1, dropout=0.0,
               norm_groups=1, image_size=64)
    jm = JaxDY3h(**cfg)
    z = np.zeros((1, 64, 64, 6), np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), z,
                              np.ones((1, 1), np.float32),
                              z[..., :3])['params']
    out = {}
    convert_jax._dy3h(jax.tree_util.tree_map(np.asarray, params), '', out)
    pm = DY3h(**cfg).eval()
    pm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in out.items()}, strict=True)
    return jm, params, pm


def _sched_opt(steps=STEPS + 1):
    return {'schedule': 'linear', 'n_timestep': steps,
            'linear_start': 1e-6, 'linear_end': 0.4}


@pytest.mark.parametrize('continous', [False, True])
def test_resident_equals_reassembling_bitwise(rng, continous):
    """96 x 96, skip 64, padding 16 (16 windows, snapped and repeated), 3
    steps: the same draws through p_sample_loop over tiled_denoise_fn and
    through resident_reverse give the same bits, snapshots included."""
    _, _, pm = _tiny_dy3h()
    sched = make_schedule(_sched_opt())
    x = torch.from_numpy((rng.standard_normal((1, 96, 96, 3)) * 0.2)
                         .astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((1, 96, 96, 3)) * 0.2)
                         .astype(np.float32))
    draws = [torch.from_numpy(rng.standard_normal((1, 96, 96, 3))
                              .astype(np.float32)) for _ in range(4)]
    with torch.no_grad():
        it = iter(draws)
        fn = tiled.tiled_denoise_fn(pm, x, g, skip=SKIP, padding=PADDING)
        old = p_sample_loop(fn, x, sched, lambda s: next(it),
                            continous=continous)
        it = iter(draws)
        new = resident.resident_reverse(pm, sched, x, x, g,
                                        lambda s: next(it),
                                        continous=continous, skip=SKIP,
                                        padding=PADDING)
    if continous:
        assert new[1].shape == old[1].shape == (4, 1, 96, 96, 3)
        assert torch.equal(new[1], old[1])
        new, old = new[0], old[0]
    assert torch.equal(new, old)


def test_resident_in_bf16(rng, monkeypatch):
    """The networks in bf16, the sampler state in float32: the resident
    path keeps the reassembling path's bits, and lies within bf16's gate
    (0.05 mean abs) of the float32 restoration."""
    torch.manual_seed(6)
    model = define_G(toy_opt()).eval()
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=STEPS))
    sr = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3))
                          .astype(np.float32))
    draws = [torch.from_numpy(rng.standard_normal((1, 96, 96, 3))
                              .astype(np.float32)) for _ in range(STEPS + 1)]
    tile = {'skip': SKIP, 'padding': PADDING}

    def restore(resident_path, dtype):
        model.resident = resident_path
        it = iter(draws)
        return eval_step(model, sched, sr, pad=16, tile=tile,
                         noise=lambda s: next(it), compute_dtype=dtype)[0]

    got = restore(True, torch.bfloat16)
    assert got.dtype == torch.float32
    assert torch.equal(got, restore(False, torch.bfloat16))
    assert (got - restore(True, None)).abs().mean().item() < 0.05


def test_resident_matches_jax_resident_reverse(rng):
    """resident_reverse against the JAX package's with its draws injected
    (jax.random.normal of its keys, the step draws taken flat as it takes
    them)."""
    jm, params, pm = _tiny_dy3h()
    x = (rng.standard_normal((1, 96, 96, 3)) * 0.2).astype(np.float32)
    g = (rng.standard_normal((1, 96, 96, 3)) * 0.2).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda k: jax_resident.resident_reverse(
        jm, params, jax_make_schedule(_sched_opt()), jnp.asarray(x),
        jnp.asarray(x), jnp.asarray(g), k, skip=SKIP,
        padding=PADDING))(key)
    shape = x.shape
    key, k0 = jax.random.split(key)
    draws = [np.array(jax.random.normal(k0, shape, np.float32))]
    for _ in range(STEPS + 1):
        key, k = jax.random.split(key)
        draws.append(np.array(jax.random.normal(
            k, (shape[0], shape[1], shape[2] * shape[3]),
            np.float32)).reshape(shape))
    it = iter(draws)
    with torch.no_grad():
        got = resident.resident_reverse(
            pm, make_schedule(_sched_opt()), torch.from_numpy(x),
            torch.from_numpy(x), torch.from_numpy(g),
            lambda s: torch.from_numpy(next(it)), skip=SKIP, padding=PADDING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_large_inputs_take_the_resident_path(monkeypatch):
    """Tiled DDPM goes through resident_reverse by default, with the tile
    options; UCDIR_TPU_NO_RESIDENT=1, read by define_G, sends it through the
    reassembling path; ddim always goes there."""
    seen = []

    class Stop(Exception):
        pass

    def fake(kind):
        def f(*args, **kw):
            seen.append((kind, {k: kw[k] for k in ('skip', 'padding',
                                                    'tile_chunk',
                                                    'distributed')}))
            raise Stop
        return f

    monkeypatch.setattr(resident, 'resident_reverse', fake('resident'))
    monkeypatch.setattr(tiled, 'tiled_denoise_fn', fake('tiled'))
    opt = toy_opt()
    sched = make_schedule(SID_VAL_SCHEDULE)
    x = torch.zeros(1, 40, 40, 3)
    tile = {'skip': 64, 'padding': 8}
    kw = dict(skip=64, padding=8, tile_chunk=1, distributed=False)
    model = define_G(opt).eval()
    assert model.resident
    for sampler in ('ddpm', 'ddim'):
        with pytest.raises(Stop):
            eval_step(model, sched, x, pad=16, tile=tile, sampler=sampler,
                      generator=torch.Generator())
    monkeypatch.setenv('UCDIR_TPU_NO_RESIDENT', '1')
    model = define_G(opt).eval()
    assert not model.resident
    with pytest.raises(Stop):
        eval_step(model, sched, x, pad=16, tile=tile,
                  generator=torch.Generator())
    assert seen == [('resident', kw), ('tiled', kw), ('tiled', kw)]
    assert port_sampler.UNTILED_MAX_PX == 4_300_000


def _ranks_and_one(tmp, model, sr, pad, tile, ddpm, ddim, tile_chunk=None):
    """`sr` restored by two gloo ranks (tests/torch_resident_worker.py,
    tile_chunk `tile_chunk` or the world size) and by one process (tile_chunk
    `tile_chunk` or 1), DDPM and ddim with STEPS steps and the given draws:
    (the ranks' outputs and collectives, one process's outputs)."""
    torch.save(model.state_dict(), tmp / 'weights.pt')
    data = {'sr': sr}
    data.update({'ddpm_%d' % i: d for i, d in enumerate(ddpm)})
    data.update({'ddim_%d' % i: d for i, d in enumerate(ddim)})
    np.savez(tmp / 'data.npz', **data)
    job = {'weights': str(tmp / 'weights.pt'), 'data': str(tmp / 'data.npz'),
           'out': str(tmp), 'tile': tile, 'pad': pad, 'steps': STEPS,
           'n_ddpm': len(ddpm), 'n_ddim': len(ddim)}
    if tile_chunk is not None:
        job['tile_chunk'] = tile_chunk
    (tmp / 'job.json').write_text(json.dumps(job))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(tmp / 'job.json')], cwd=tmp,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
                 RANK=str(r), WORLD_SIZE='2', LOCAL_RANK=str(r),
                 MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, 'rank %d failed:\n%s\n%s' % (
                r, out[-2000:], err[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [dict(np.load(tmp / ('rank%d.npz' % r))) for r in range(2)]
    one = {}
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=STEPS))
    one_tile = dict(tile, tile_chunk=tile_chunk or 1)
    # one thread, as the ranks run: the host's convolutions add in an order
    # that depends on the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for sampler, draws in (('ddpm', ddpm), ('ddim', ddim)):
            it = iter(draws)
            one[sampler] = eval_step(
                model, sched, torch.from_numpy(sr), pad=pad, tile=one_tile,
                sampler=sampler, sampling_timesteps=STEPS,
                noise=lambda s: torch.from_numpy(next(it)))[0].numpy()
    finally:
        torch.set_num_threads(threads)
    return ranks, one


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """The toy model's restoration of one 64 x 64 input (96 x 96 after the
    16-px pad: 16 windows of 64 with 16-px halos) by two gloo ranks, DDPM
    and ddim with STEPS steps; the same in one process; the weights and the
    draws, which the JAX package's draws fill."""
    tmp = tmp_path_factory.mktemp('resident_ranks')
    rng = np.random.default_rng(11)
    torch.manual_seed(4)
    model = define_G(toy_opt()).eval()
    sr = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    shape = (1, 96, 96, 3)
    key, k0 = jax.random.split(key)
    ddpm = [np.array(jax.random.normal(k0, shape, np.float32))]
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        ddpm.append(np.array(jax.random.normal(
            k, (1, 96, 96 * 3), np.float32)).reshape(shape))
    ddim = [rng.standard_normal(shape).astype(np.float32)
            for _ in range(STEPS + 1)]
    tile = {'skip': SKIP, 'padding': PADDING}
    ranks, one = _ranks_and_one(tmp, model, sr, 16, tile, ddpm, ddim)
    return {'ranks': ranks, 'one': one, 'model': model, 'sr': sr,
            'key': jax.random.PRNGKey(5), 'tile': tile}


@pytest.mark.parametrize('sampler', ['ddpm', 'ddim'])
def test_two_ranks_equal_one_process_bitwise(two_ranks, sampler):
    """Each rank's restoration, one image's tiles split over the two, has
    the bits of one process's (tile_chunk 1): DDPM on the resident path,
    ddim on the tiled one."""
    want = two_ranks['one'][sampler]
    for r in two_ranks['ranks']:
        assert r[sampler].shape == (1, 64, 64, 3)
        np.testing.assert_array_equal(r[sampler], want)


def test_resident_ranks_gather_only_at_the_end(two_ranks):
    """The resident path's collectives: one all_reduce before the steps (the
    ranks' geometry agreed), one batch_isend_irecv a step (the overlaps),
    then one all_gather of the image at the end, nothing else;
    the tiled ddim path all-gathers the centers once a step."""
    for r in two_ranks['ranks']:
        assert list(r['ddpm_ops']) == (['all_reduce']
                                       + ['batch_isend_irecv'] * STEPS
                                       + ['all_gather'])
        assert list(r['ddim_ops']) == ['all_gather'] * STEPS


def test_rank_holding_only_dummies(tmp_path):
    """A 56 x 48 input with an 8-px pad (72 x 64, above one window, so it
    tiles), windows of 64 with 8-px halos: 4 tiles, padded to tile_chunk 8, so rank 1 holds 4 dummies and no tile of
    the image. It joins the collectives only (no exchange on either rank:
    rank 0 holds every tile), and both ranks give one process's bits at the
    same tile_chunk, DDPM (resident) and ddim (tiled)."""
    rng = np.random.default_rng(12)
    torch.manual_seed(6)
    model = define_G(toy_opt()).eval()
    sr = rng.uniform(-1, 1, (1, 56, 48, 3)).astype(np.float32)
    tile = {'skip': 64, 'padding': 8}
    plan = resident.ResidentPlan(72, 64, **tile)
    assert plan.n_tiles == 4
    shape = (1, 72, 64, 3)
    draws = [[rng.standard_normal(shape).astype(np.float32)
              for _ in range(STEPS + 1)] for _ in range(2)]
    ranks, one = _ranks_and_one(tmp_path, model, sr, 8, tile, *draws,
                                tile_chunk=8)
    for r in ranks:
        for sampler in ('ddpm', 'ddim'):
            assert r[sampler].shape == (1, 56, 48, 3)
            np.testing.assert_array_equal(r[sampler], one[sampler])
        assert list(r['ddpm_ops']) == ['all_reduce', 'all_gather']
        assert list(r['ddim_ops']) == ['all_gather'] * STEPS


def test_two_ranks_match_jax_two_device_eval_step(two_ranks):
    """The ranks' DDPM restoration against make_eval_step on a mesh of 2
    (tile_chunk 2, the tiles over the devices, the shard_map exchange),
    its draws injected on the port's side."""
    opt = toy_opt()
    params = convert_state_dict(two_ranks['model'].state_dict())
    step = make_eval_step(jax_define_G(opt), jax_make_schedule(
        dict(SID_VAL_SCHEDULE, n_timestep=STEPS)), pad=16,
        mesh=make_mesh(2), tile=dict(two_ranks['tile']))
    want = step({'params': params}, two_ranks['sr'], two_ranks['key'])[0]
    for r in two_ranks['ranks']:
        np.testing.assert_allclose(r['ddpm'], np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_cli_ranks_share_each_validation_image(tmp_path):
    """`sr.main -p train --distributed` on two gloo ranks with a `tile` dict:
    the global batch of 2 split one image a rank, and at each validation
    both ranks restore both images together (every rank walks the whole
    set, the tiles split over them); rank 0 alone saves the images, under
    its names, and logs one mean; nothing of JAX is imported."""
    _tiny_yaml(tmp_path)
    cfg = yaml.safe_load((tmp_path / 'tiny.yaml').read_text())
    cfg['tile'] = {'skip': 128, 'padding': 16}
    cfg['datasets']['train']['batch_size'] = 2
    cfg['train'].update(n_iter=2, print_freq=2, val_freq=2,
                        save_checkpoint_freq=2)
    cfg['model']['beta_schedule']['val']['n_timestep'] = 2
    (tmp_path / 'tiny.yaml').write_text(yaml.safe_dump(cfg))
    argv = [sys.executable, '-c', _CLI, '-p', 'train', '-c', 'tiny.yaml',
            '--device', 'cpu', '--distributed']
    log0, log1 = _run_ranks([argv, argv], tmp_path, timeout=300)
    assert log0.count('# Validation # PSNR: ') == 1
    assert 'Validation' not in log1
    saved = sorted(f for _, _, fs in os.walk(tmp_path) for f in fs
                   if f.endswith('_sr.png'))
    assert saved == ['2_1_sid-tiny_sr.png', '2_2_sid-tiny_sr.png']
