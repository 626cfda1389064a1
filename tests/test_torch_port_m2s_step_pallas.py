"""PyTorch port: one stage-1 M2SNet step in float32, strategy "easy",
share_encodes False, on the port's "pallas_train" music path (the float32
modes of K4, K9, K10 and K11, through their plain versions on the CPU) and
on its "lax" path, against the JAX trainer's float32 "pallas_train" step,
its Pallas kernels in interpret mode, JAX's pair starts handed over
(B = 2, 6-s samples, 2-s crops: the size of tests/test_conv_train.py:
289-330).  The bounds are those of tests/test_torch_port_m2s_parity.py
(`check_port_step`): the JAX package's own lax / packed bounds (loss rtol
1e-4, accuracy 1e-6, every parameter after Adam within 5e-3,
tests/test_conv_train.py:314, 324) and the BN statistics within 1e-5.  The
gradients against the exact float64 one are the other step files' (the
JAX step in interpret mode takes most of this file's ~2 min)."""

import pytest
import torch
from test_torch_port_m2s_parity import check_port_step, jax_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    return jax_step("easy", False, conv_impl="pallas_train", exact=False)


@pytest.mark.parametrize("conv_impl", ["pallas_train", "lax"])
def test_float32_step_matches_jax_pallas_train_step(reference, conv_impl):
    check_port_step(conv_impl, "easy", False, reference)
