"""One rank of the two-process gloo runs of tests/test_torch_port_resident.py:
one image's tiles split over the ranks.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_resident_worker.py <job.json>

The job names the model's state dict (`weights`, a torch.save of the toy
model of `toy_opt`), an .npz with the input `sr` and the injected draws
(`ddpm_<i>`, `ddim_<i>`, the same on every rank), the tile dict and the
output directory, and may name a `tile_chunk` (else the world size). The
rank restores `sr` through `eval_step` with {**tile, tile_chunk,
distributed: True}: DDPM (the tile-resident path)
and ddim (the tiled path, its centers all-gathered every step), counting
every collective it issues. Writes `rank<r>.npz`: the two outputs and the
collectives in order (`ddpm_ops`, `ddim_ops`); fails if anything of JAX or
of the JAX package was imported.
"""
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COLLECTIVES = ('all_gather', 'all_gather_into_tensor', 'all_reduce',
               'broadcast', 'reduce_scatter', 'all_to_all',
               'batch_isend_irecv', 'send', 'recv', 'barrier')


def toy_opt():
    from ucdir_tpu_torch.configs import SID_MODEL
    model = copy.deepcopy(SID_MODEL)
    model['unet'].update(inner_channel=8, channel_mults=[1, 2],
                         res_blocks=1, attn_res=[], dropout=0.0)
    return {'model': model}


def count_collectives(ops):
    """Wraps torch.distributed's collectives so that each call appends its
    name to `ops`; returns a function that puts the originals back."""
    import torch.distributed as dist
    originals = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            ops.append(name)
            return fn(*args, **kwargs)
        return counted

    for name, fn in originals.items():
        setattr(dist, name, wrap(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(dist, name, fn)
    return restore


def main():
    with open(sys.argv[1]) as f:
        job = json.load(f)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from ucdir_tpu_torch.configs import SID_VAL_SCHEDULE
    from ucdir_tpu_torch.eval import eval_step
    from ucdir_tpu_torch.models.factory import define_G
    from ucdir_tpu_torch.schedule import make_schedule
    from ucdir_tpu_torch.utils.dist import exit_dist, get_dist_info, init_dist

    init_dist('pytorch', device='cpu')
    rank, world = get_dist_info()
    model = define_G(toy_opt()).eval()
    model.load_state_dict(torch.load(job['weights'], weights_only=True))
    data = np.load(job['data'])
    sr = torch.from_numpy(data['sr'])
    tile = dict(job['tile'], tile_chunk=job.get('tile_chunk', world),
                distributed=True)
    out = {}
    for sampler in ('ddpm', 'ddim'):
        draws = iter([torch.from_numpy(data['%s_%d' % (sampler, i)])
                      for i in range(job['n_' + sampler])])
        ops = []
        restore = count_collectives(ops)
        out[sampler] = eval_step(
            model, make_schedule(dict(SID_VAL_SCHEDULE,
                                      n_timestep=job['steps'])),
            sr, pad=job['pad'], tile=tile, sampler=sampler,
            sampling_timesteps=job['steps'],
            noise=lambda shape: next(draws))[0].numpy()
        restore()
        out[sampler + '_ops'] = np.asarray(ops)
    np.savez(os.path.join(job['out'], 'rank%d.npz' % rank), **out)
    exit_dist()
    bad = sorted(k for k in sys.modules if k.split('.')[0] in
                 ('ucdir_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))
    if bad:
        sys.exit('imported %s' % bad)


if __name__ == '__main__':
    main()
