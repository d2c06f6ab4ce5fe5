"""The port's data-parallel runs on the CPU: two gloo ranks (processes of
tests/torch_dist_worker.py, as tests/test_multihost.py runs the JAX
package's) against the JAX package's global-batch step and against the
port's own one-process step; `_global_mean`; the validation shards against
the JAX package's EnlargedSampler; `init_dist`'s refusals; and `sr.main
--distributed` on two ranks, with nothing of JAX imported.

Tolerances: against the JAX package, test_torch_port_train's
(`check_losses`: 1e-5 rel on the first loss, 2e-4 after; `check_params`:
within 2 * lr a step, the denoiser's within 0.1 lr on average); two ranks
against one process, float32 on both sides with the batch's sums in another
order, the losses within 1e-5 rel and the parameters by `check_params`; the
ranks among themselves bit for bit.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ucdir_tpu.data.sampler import EnlargedSampler as JaxSampler
from ucdir_tpu.models.factory import define_G as jax_define_G
from ucdir_tpu.schedule import make_schedule as jax_make_schedule
from ucdir_tpu.train import (create_train_state as jax_create_state,
                             make_optimizer as jax_make_optimizer,
                             make_train_step)
from ucdir_tpu.utils.convert_torch import convert_state_dict
from ucdir_tpu_torch.data import create_dataloader
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.trainer import Trainer
from ucdir_tpu_torch.utils import dist as port_dist
from ucdir_tpu_torch.utils.convert_jax import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
from test_torch_port_train import (_CLI, _tiny_yaml, check_losses,  # noqa
                                   check_params, jax_draws, toy_batch)
from torch_dist_worker import LR, toy_model  # noqa: E402

torch.set_num_threads(2)

WORKER = os.path.join(ROOT, 'tests', 'torch_dist_worker.py')
EMA_OPT = {'use': True, 'ema_decay': 0.5, 'step_start_ema': 1,
           'update_ema_every': 1}
STEPS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_env(rank, world, port):
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))


def _run_ranks(argvs, cwd, world=2, timeout=240):
    """Runs one process per rank (argvs[r] for rank r), each with its own
    timeout; returns their stderr, failing on any non-zero exit."""
    port = _free_port()
    procs = [subprocess.Popen(argv, cwd=cwd, env=_rank_env(r, world, port),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r, argv in enumerate(argvs)]
    errs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, 'rank %d failed:\n%s\n%s' % (
                r, out[-2000:], err[-4000:])
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return errs


def _workers(tmp_path, mode, data, dropout=0.0, steps=STEPS):
    np.savez(tmp_path / 'data.npz', **data)
    job = tmp_path / 'job.json'
    job.write_text(json.dumps({'mode': mode, 'data': str(tmp_path /
                                                         'data.npz'),
                               'out': str(tmp_path), 'dropout': dropout,
                               'steps': steps}))
    _run_ranks([[sys.executable, WORKER, str(job)]] * 2, tmp_path)
    return [dict(np.load(tmp_path / ('rank%d.npz' % r))) for r in range(2)]


def _prefixed(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _same_bits_across_ranks(outs):
    a, b = outs
    assert a.keys() == b.keys()
    for k in a:
        if k != 'gmean':
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_ranks_take_the_jax_global_batch_step(rng, tmp_path):
    """Two ranks, one image each, against make_train_step at the global
    batch of 2 with the same injected gammas and noise and dropout 0: the
    losses and the parameters after 2 AdamW steps; every rank holds the same
    bits of the parameters, the EMA and the AdamW state; `_global_mean` of
    sums 10 + r over counts 2 + r is (10 + 11) / (2 + 3)."""
    opt = {'model': toy_model(0.0)}
    torch.manual_seed(2)
    model = define_G(opt)
    sched_opt = opt['model']['beta_schedule']['train']
    jm, jsched = jax_define_G(opt), jax_make_schedule(sched_opt)
    jstate = jax_create_state(convert_state_dict(model.state_dict()),
                              jax_make_optimizer({'type': 'adamw',
                                                  'lr': LR}), EMA_OPT)
    jstep = make_train_step(jm, jsched, donate=False)
    batch = toy_batch(rng, B=2)
    data = dict(batch)
    want = []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), STEPS)):
        data['gammas_%d' % i], data['noise_%d' % i] = jax_draws(
            key, jsched, batch['HR'].shape)
        jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, key)
        want.append(float(m['l_pix']))

    outs = _workers(tmp_path, 'step', data)
    _same_bits_across_ranks(outs)
    check_losses(list(zip(outs[0]['losses'], want)))
    got, ref = _prefixed(outs[0], 'p/'), {
        k: v.numpy() for k, v in from_jax_params(jstate.params).items()}
    assert got.keys() == ref.keys()
    check_params(got, ref, STEPS)
    for o in outs:
        assert o['gmean'] == 21.0 / 5.0


def test_two_ranks_with_dropout_equal_one_process(rng, tmp_path):
    """Trainer.optimize_parameters with dropout 0.1, its draws from the
    step generator: two ranks, one image each, each building its model from
    another seed, equal the one-process Trainer at the global batch of 2
    (the noise levels, the noise and the dropout mask drawn at the global
    batch, the weights rank 0's); the ranks hold the same bits."""
    batch = toy_batch(rng, B=2)
    outs = _workers(tmp_path, 'trainer', dict(batch), dropout=0.1)
    _same_bits_across_ranks(outs)

    opt = {'phase': 'train', 'model': toy_model(0.1),
           'path': {'resume_state': None,
                    'checkpoint': str(tmp_path / 'one')},
           'train': {'optimizer': {'type': 'adamw', 'lr': LR},
                     'ema_scheduler': EMA_OPT}}
    torch.manual_seed(2)     # rank 0's seed
    one = Trainer(opt, device='cpu', seed=5)
    losses = []
    for _ in range(STEPS):
        one.feed_data(batch)
        one.optimize_parameters()
        losses.append(one.get_current_log()['l_pix'])
    np.testing.assert_allclose(outs[0]['losses'], losses, rtol=1e-5)
    check_params(_prefixed(outs[0], 'p/'),
                 {k: v.detach().numpy()
                  for k, v in one.model.state_dict().items()}, STEPS)


class _Items:
    """A validation set of `n` items that only carry their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'Index': i, 'SR': np.full((2, 2, 3), i, np.float32)}


@pytest.mark.parametrize('n,world,val_batch', [(5, 2, 1), (7, 3, 2),
                                               (4, 2, 2)])
def test_val_shards_are_the_jax_samplers_padded_index_sets(n, world,
                                                           val_batch):
    """Each rank's validation loader yields the JAX package's
    EnlargedSampler shard of that rank, in its order, padded to a multiple
    of the world size with repeated indices; the ranks together cover every
    index."""
    items = _Items(n)
    seen = []
    for rank in range(world):
        loader = create_dataloader(items, {'val_batch': val_batch}, 'val',
                                   rank=rank, world_size=world)
        got = [int(i) for b in loader for i in b['Index']]
        assert got == list(JaxSampler(items, world, rank))
        seen += got
    assert len(seen) % world == 0 and set(seen) == set(range(n))


def test_init_dist_raises_without_a_launch(monkeypatch):
    """No torchrun environment, a launcher it does not know, and more NCCL
    ranks on a host than it has cards each raise; none falls back to one
    process."""
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match='torchrun'):
        port_dist.init_dist('pytorch', device='cpu')
    with pytest.raises(ValueError, match='launcher'):
        port_dist.init_dist('mpi', device='cpu')
    monkeypatch.setenv('RANK', '1')
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('LOCAL_RANK', '1')
    monkeypatch.setenv('MASTER_ADDR', '127.0.0.1')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        port_dist.init_dist('pytorch', device='cuda')
    assert port_dist.get_dist_info() == (0, 1)


def test_a_slurm_rank_joins_and_leaves_its_group(monkeypatch):
    """srun's variables form a group (one rank of gloo here); master_only
    runs on rank 0; exit_dist leaves the group."""
    for k, v in (('SLURM_PROCID', '0'), ('SLURM_NTASKS', '1'),
                 ('SLURM_LOCALID', '0'), ('MASTER_ADDR', '127.0.0.1'),
                 ('MASTER_PORT', str(_free_port()))):
        monkeypatch.setenv(k, v)
    assert port_dist.init_dist('slurm', device='cpu') == torch.device('cpu')
    try:
        assert port_dist.get_dist_info() == (0, 1)
        assert port_dist.master_only(lambda: 7)() == 7
    finally:
        port_dist.exit_dist()
    assert port_dist.get_dist_info() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_init_dist_raises_when_the_group_does_not_form(tmp_path):
    """Rank 0 of 2 whose partner never comes raises once the timeout has
    passed."""
    code = ('import datetime\n'
            'from ucdir_tpu_torch.utils.dist import init_dist\n'
            'try:\n'
            '    init_dist("pytorch", device="cpu",\n'
            '              timeout=datetime.timedelta(seconds=3))\n'
            'except RuntimeError as e:\n'
            '    print("raised", type(e).__name__)\n')
    env = _rank_env(0, 2, _free_port())
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith('raised'), proc.stdout


def test_cli_trains_on_two_ranks_loads_no_jax(tmp_path):
    """`sr.main -p train --distributed` on two gloo ranks, the config's
    batch of 2 split one image a rank, 2 steps (print, validate on 2 steps
    of the val schedule and save at step 2): both finish, rank 0 logs the
    step and the validation and saves the triple, rank 1 logs nothing;
    neither imports anything of JAX or of the JAX package. (Not -debug:
    it sets a batch of 2 a rank, which the 2 pairs cannot fill.)"""
    _tiny_yaml(tmp_path)
    cfg = yaml.safe_load((tmp_path / 'tiny.yaml').read_text())
    cfg['datasets']['train']['batch_size'] = 2
    cfg['train'].update(n_iter=2, print_freq=2, val_freq=2,
                        save_checkpoint_freq=2)
    cfg['model']['beta_schedule']['train']['n_timestep'] = 10
    cfg['model']['beta_schedule']['val']['n_timestep'] = 2
    (tmp_path / 'tiny.yaml').write_text(yaml.safe_dump(cfg))
    argv = [sys.executable, '-c', _CLI, '-p', 'train', '-c', 'tiny.yaml',
            '--device', 'cpu', '--distributed']
    log0, log1 = _run_ranks([argv, argv], tmp_path, timeout=300)
    assert log0.count('l_pix: ') == 1
    assert log0.count('# Validation # PSNR: ') == 1
    assert 'End of training.' in log0 and 'l_pix' not in log1
    saved = sorted(f for _, _, fs in os.walk(tmp_path) for f in fs
                   if f.endswith('.pth'))
    assert saved == ['I_Elatest_gen.pth', 'I_Elatest_gen_ema.pth',
                     'I_Elatest_opt.pth']
