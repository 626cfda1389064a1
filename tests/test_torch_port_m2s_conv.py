"""PyTorch port: the stage-1 music encoder's trainable 3x3 conv against the
JAX package's Pallas function in interpret mode, on the CPU (the kernels'
plain versions through the port's autograd Function): `conv3x3_train` (K4
forward and d(input), K9 d(kernel)) against JAX `conv3x3_train`, forward
and both gradients, at the cases of tests/test_conv_train.py (:30-34) and
its bounds (:47, :68, :73); and K9's plain version against torch's
convolution weight gradient at the encoder's widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.ops.conv_train import conv3x3_train as jax_conv3x3_train
from conductor_tpu_torch.ops import conv3x3_train
from conductor_tpu_torch.ops.conv_train import conv3x3_dkernel_plain

torch.set_num_threads(2)

CONV_CASES = [
    # (B, T, F, Cin, Cout): first block, mid block, widening block, stage 3
    (1, 8, 128, 1, 16),
    (2, 12, 16, 16, 16),
    (2, 12, 16, 16, 32),
    (2, 10, 32, 32, 32),
]


@pytest.mark.parametrize("b,t,f,cin,cout", CONV_CASES)
def test_conv3x3_train_matches_jax(b, t, f, cin, cout):
    rng = np.random.RandomState(f + cin)
    x = rng.normal(size=(b, t, f, cin)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(b, t, f, cout)).astype(np.float32)

    want, vjp = jax.vjp(jax_conv3x3_train, jnp.asarray(x.reshape(b, t, f * cin)),
                        jnp.asarray(kernel))
    dx_want, dw_want = vjp(jnp.asarray(dy.reshape(b, t, f * cout)))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(kernel).requires_grad_(True)
    got = conv3x3_train(xt, wt)
    got.backward(torch.from_numpy(dy))

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).reshape(b, t, f, cout),
                               atol=1e-5, rtol=1e-5)
    scale = float(np.abs(np.asarray(dx_want)).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want).reshape(b, t, f, cin),
                               atol=1e-5 * max(scale, 1.0), rtol=2e-5)
    wscale = float(np.abs(np.asarray(dw_want)).max())
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_want),
                               atol=2e-5 * max(wscale, 1.0), rtol=2e-5)


# the (F, Cin, Cout) of the stage-1 encoder's seven convs (blocks 1, 2-3, 4,
# 5, 6-7)
ENCODER_WIDTHS = [(128, 1, 16), (128, 16, 16), (64, 16, 32), (64, 32, 32), (32, 32, 32)]


@pytest.mark.parametrize("t", [7, 12])
@pytest.mark.parametrize("f,cin,cout", ENCODER_WIDTHS)
def test_conv3x3_dkernel_plain_matches_conv2d_weight(f, cin, cout, t):
    """K9's plain version, the yardstick the kernel is held to on the card,
    against torch's convolution weight gradient of the reflect-padded input,
    in float64."""
    rng = np.random.RandomState(f + cin + cout + t)
    x = torch.from_numpy(rng.normal(size=(1, t, f, cin)))
    dy = torch.from_numpy(rng.normal(size=(1, t, f, cout)))
    got = conv3x3_dkernel_plain(x, dy)
    xe = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    want = torch.nn.grad.conv2d_weight(xe, (cout, cin, 3, 3), dy.permute(0, 3, 1, 2))
    want = want.permute(2, 3, 1, 0)  # (Cout, Cin, 3, 3) -> (3, 3, Cin, Cout)
    assert got.dtype == torch.float64 and got.shape == (3, 3, cin, cout)
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_conv3x3_train_skips_the_input_gradient():
    """The first block's input takes no gradient: d(input) is not computed
    (its transposed conv would have Cout = 1, which K4 does not take)."""
    x = torch.randn(1, 6, 16, 1)
    w = torch.randn(3, 3, 1, 16, requires_grad=True)
    conv3x3_train(x, w).sum().backward()
    assert x.grad is None and w.grad is not None
