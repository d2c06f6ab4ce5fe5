"""One rank of the two-process gloo runs of tests/test_torch_port_dist.py.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py <job.json>

The job names a mode, an input .npz and an output directory:
  step     `train_step` on the rank's rows of the global batch in the .npz,
           with the global batch's gammas and noise injected (`gammas_<i>`,
           `noise_<i>` for step i), from the weights of torch seed 2;
  trainer  `Trainer.optimize_parameters` on the rank's rows, its draws
           (dropout included) from the trainer's step generator, each rank
           building its model from another torch seed (the trainer starts
           every rank from rank 0's weights).
Both also take `sr._global_mean(10 + rank, 2 + rank)`. Writes
`rank<r>.npz`: the losses, the parameters (`p/`), the EMA shadow (`e/`),
the AdamW state (`o/`) and the global mean; fails if anything of JAX or of
the JAX package was imported.
"""
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LR = 1e-4


def toy_model(dropout):
    from ucdir_tpu_torch.configs import SID_MODEL
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(inner_channel=16, channel_mults=[1, 2],
                         res_blocks=1, attn_res=[], dropout=dropout)
    model['beta_schedule']['train'] = dict(
        schedule='linear', n_timestep=10, linear_start=1e-6, linear_end=1e-2)
    return model


def main():
    with open(sys.argv[1]) as f:
        job = json.load(f)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from ucdir_tpu_torch import sr
    from ucdir_tpu_torch.parallel.mesh import data_shard
    from ucdir_tpu_torch.utils.dist import exit_dist, get_dist_info, init_dist

    init_dist('pytorch', device='cpu')
    rank, world = get_dist_info()
    data = np.load(job['data'])
    batch = {k: data_shard(torch.from_numpy(data[k]), rank, world)
             for k in ('HR', 'SR')}
    ema_opt = {'use': True, 'ema_decay': 0.5, 'step_start_ema': 1,
               'update_ema_every': 1}
    losses = []
    if job['mode'] == 'step':
        from ucdir_tpu_torch.models.factory import define_G
        from ucdir_tpu_torch.schedule import make_schedule
        from ucdir_tpu_torch.train import (create_train_state,
                                           make_optimizer, train_step)
        opt = {'model': toy_model(job['dropout'])}
        torch.manual_seed(2)
        model = define_G(opt).train()
        state = create_train_state(
            model, make_optimizer(model.parameters(),
                                  {'type': 'adamw', 'lr': LR}), ema_opt)
        sched = make_schedule(opt['model']['beta_schedule']['train'])
        for i in range(job['steps']):
            draws = {k: torch.from_numpy(data['%s_%d' % (k, i)])
                     for k in ('gammas', 'noise')}
            losses.append(train_step(state, sched, batch, draws=draws,
                                     rank=rank, world_size=world).item())
    else:
        from ucdir_tpu_torch.trainer import Trainer
        opt = {'phase': 'train', 'model': toy_model(job['dropout']),
               'path': {'resume_state': None,
                        'checkpoint': os.path.join(job['out'], 'ckpt')},
               'train': {'optimizer': {'type': 'adamw', 'lr': LR},
                         'ema_scheduler': ema_opt}}
        torch.manual_seed(2 + rank)
        trainer = Trainer(opt, device='cpu', seed=5)
        state = trainer.state
        for _ in range(job['steps']):
            trainer.feed_data({k: v.numpy() for k, v in batch.items()})
            trainer.optimize_parameters()
            losses.append(trainer.get_current_log()['l_pix'])
    (gmean,) = sr._global_mean(10.0 + rank, 2.0 + rank)
    out = {'losses': np.asarray(losses, np.float64), 'gmean': gmean}
    out.update({'p/' + k: v.detach().numpy()
                for k, v in state.model.state_dict().items()})
    out.update({'e/' + k: v.numpy() for k, v in state.ema_params.items()})
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out['o/%s/%s' % (names[id(p)], k)] = np.asarray(v)
    np.savez(os.path.join(job['out'], 'rank%d.npz' % rank), **out)
    exit_dist()
    bad = sorted(k for k in sys.modules if k.split('.')[0] in
                 ('ucdir_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))
    if bad:
        sys.exit('imported %s' % bad)


if __name__ == '__main__':
    main()
