"""Batched validation and the gradient all-reduce on the card. Marked `gpu`:
skipped where CUDA is unavailable.

    python -m pytest --noconftest tests/test_torch_port_dist_gpu.py -q   # H100

The full-width SID model restores 96 x 96 images at a batch of 1, 2 and 4,
each image with draws of its own, and each image alone: the kernels' tiles
change with the batch, so the bits may too. Tolerance: float32 1e-5 max abs
(the card-against-host limit of chip_smoke's slice), bf16 1e-3 mean abs (its
bf16 slice's). `all_reduce_mean_` on a one-rank NCCL group keeps every bit
of a real step's gradients.
"""
import copy
import socket

import pytest
import torch

from ucdir_tpu_torch.configs import SID_MODEL, SID_VAL_SCHEDULE
from ucdir_tpu_torch.eval import eval_step
from ucdir_tpu_torch.models.factory import define_G
from ucdir_tpu_torch.schedule import make_schedule

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _model(dev, dropout=0.1):
    model = copy.deepcopy(SID_MODEL)
    model['unet']['dropout'] = dropout
    torch.manual_seed(0)
    return define_G({'model': model}).to(dev)


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
@pytest.mark.parametrize('batch', [1, 2, 4])
def test_batched_restoration_agrees_with_each_image_alone(dev, batch, dtype):
    model = _model(dev).eval()
    sched = make_schedule(dict(SID_VAL_SCHEDULE, n_timestep=2), dev)
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.rand((batch, 96, 96, 3), generator=gen, device=dev) * 2 - 1
    draws = [[torch.randn((1, 224, 224, 3), generator=gen, device=dev)
              for _ in range(3)] for _ in range(batch)]

    def noise(images):
        k = iter(range(3))

        def draw(shape):
            i = next(k)
            return torch.cat([draws[j][i] for j in images])
        return draw

    got, _ = eval_step(model, sched, x, noise=noise(range(batch)),
                       compute_dtype=dtype)
    for j in range(batch):
        want, _ = eval_step(model, sched, x[j:j + 1], noise=noise([j]),
                            compute_dtype=dtype)
        assert torch.isfinite(got[j]).all()
        d = (got[j:j + 1] - want).abs()
        if dtype is None:
            assert d.max().item() <= 1e-5, (j, d.max().item())
        else:
            assert d.mean().item() <= 1e-3, (j, d.mean().item())


def test_all_reduce_mean_on_one_nccl_rank_keeps_the_gradients(dev):
    import torch.distributed as dist
    from ucdir_tpu_torch.parallel.mesh import all_reduce_mean_
    from ucdir_tpu_torch.train import (create_train_state, make_optimizer,
                                       train_step)

    model = _model(dev).train()
    state = create_train_state(model, make_optimizer(
        model.parameters(), {'type': 'adamw', 'lr': 1e-4}))
    gen = torch.Generator(dev).manual_seed(2)
    hr = torch.rand((2, 64, 64, 3), generator=gen, device=dev) * 2 - 1
    train_step(state, make_schedule(SID_MODEL['beta_schedule']['train'],
                                    dev),
               {'HR': hr, 'SR': 0.2 * hr}, generator=gen)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    before = [g.clone() for g in grads]
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:%d' % port,
                            rank=0, world_size=1)
    try:
        all_reduce_mean_(grads)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert grads and all(torch.equal(a, b) for a, b in zip(grads, before))
