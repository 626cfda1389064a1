"""PyTorch port: the stage-1 music encoder's max-pool against the JAX
package's Pallas functions in interpret mode, on the CPU (the kernels'
plain versions through the port's autograd Function):

- the pool (K10) exact against JAX `fused_max_pool` at the shapes of
  tests/test_pallas_pool.py;
- its first-max backward (K11) against the gradient of JAX
  `max_pool_train` on untied inputs and on tied ones (post-ReLU values
  rounded to a coarse grid), within 1e-6: each input element sums at most
  15 window cotangents, which may come in another order; and
  ``sum dx == sum dy``, the JAX test of tests/test_conv_train.py:145-159.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.ops.pallas_pool import fused_max_pool as jax_fused_max_pool
from conductor_tpu.ops.pallas_pool import max_pool_train as jax_max_pool_train
from conductor_tpu_torch.ops import fused_max_pool, max_pool_train

torch.set_num_threads(2)

POOLS = [
    # (C, F, T, window, strides, padding): the encoder's three pool stages
    (16, 128, 180, (5, 5), (1, 2), ((2, 2), (2, 2))),
    (32, 64, 180, (5, 5), (3, 2), ((2, 2), (2, 2))),
    (32, 32, 60, (3, 3), (1, 2), ((1, 1), (1, 1))),
]


@pytest.mark.parametrize("c,f,t,window,strides,padding", POOLS)
def test_pool_forward_matches_jax(c, f, t, window, strides, padding):
    x = np.random.RandomState(c + t).normal(size=(2, t, f, c)).astype(np.float32)
    want = jax_fused_max_pool(jnp.asarray(x), window, strides, padding)
    got = fused_max_pool(torch.from_numpy(x), (window, strides, padding))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tied(x):
    return np.round(np.maximum(x, 0.0) * 2) / 2  # post-ReLU plateaus, zeros included


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("c,f,t,window,strides,padding",
                         [(16, 128, 36, *POOLS[0][3:]), (32, 64, 36, *POOLS[1][3:]),
                          (32, 32, 12, *POOLS[2][3:])])
def test_pool_backward_matches_jax_tie_rule(c, f, t, window, strides, padding, tied):
    rng = np.random.RandomState(3 * c + t)
    x = rng.normal(size=(2, t, f, c)).astype(np.float32)
    if tied:
        x = _tied(x).astype(np.float32)

    def op(xf):
        return jax_max_pool_train(xf, f, c, window, strides, padding)

    y, vjp = jax.vjp(op, jnp.asarray(x.reshape(2, t, f * c)))
    dy = rng.uniform(0.1, 1.0, size=y.shape).astype(np.float32)
    (dx_want,) = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = max_pool_train(xt, (window, strides, padding))
    np.testing.assert_array_equal(got.detach().numpy().reshape(y.shape), np.asarray(y))
    got.backward(torch.from_numpy(dy).reshape(got.shape))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want).reshape(x.shape),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(xt.grad.sum()), float(dy.sum()), rtol=1e-6)
