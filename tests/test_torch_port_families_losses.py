"""The eight diffusion variants' training losses and gradients, the port
against the JAX package on the CPU, with the l1 and the l2 loss: the same
weights (the port's random ones through convert_torch), batch, gammas and
noise, dropout off; PerceptualGaussianDiffusion on random LPIPS weights in
the lpips state-dict layout. The variants' models and the sampling are in
test_torch_port_families.py.

Tolerances: a loss 1e-5 rel; a gradient 1e-3 of its parameter's largest
plus 1e-6 (float32 on both sides through ~20 layers and the predictor).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucdir_tpu_torch.diffusion.base import DIFFUSIONS
from ucdir_tpu_torch.utils.convert_jax import from_jax_grads

from test_torch_port_families import T, toy_batch, variant_pair

torch.set_num_threads(2)


@pytest.mark.parametrize('loss_type', ['l1', 'l2'])
@pytest.mark.parametrize('name', sorted(DIFFUSIONS))
def test_p_losses_and_gradients(rng, tmp_path, name, loss_type):
    """Loss and every parameter's gradient against jax.value_and_grad of the
    JAX module, same weights, batch, gammas and noise, dropout off;
    NoDiffusion at its fixed noise level, as its train step feeds it."""
    model, jm, params = variant_pair(name, tmp_path, loss_type)
    assert model.loss_type == jm.loss_type == loss_type
    # LPIPS's AlexNet needs 32 px; the others run at 16
    batch, gammas, noise = toy_batch(
        rng, 32 if name == 'PerceptualGaussianDiffusion' else 16)

    def jloss(p):
        return jm.apply({'params': p}, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                        jnp.asarray(gammas), jnp.asarray(noise),
                        deterministic=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = from_jax_grads(want_grads)
    loss = model.p_losses({k: T(v) for k, v in batch.items()}, T(gammas),
                          T(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()
           if p.grad is not None}
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, err_msg=k,
                                   atol=1e-3 * np.abs(w).max() + 1e-6)
