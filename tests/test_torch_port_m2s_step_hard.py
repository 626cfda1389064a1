"""PyTorch port: one stage-1 M2SNet step, strategy "hard", share_encodes
False, on both of the port's paths ("lax" and "pallas_train", the
kernels' plain versions) against the JAX trainer's lax float32 step, JAX's
pair starts handed over (B = 2, 6-s samples, 2-s crops).  The bounds and
the comparison are those of tests/test_torch_port_m2s_parity.py."""

import pytest
import torch
from test_torch_port_m2s_parity import check_port_step, jax_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    return jax_step("hard", False)


@pytest.mark.parametrize("conv_impl", ["lax", "pallas_train"])
def test_step_matches_jax(reference, conv_impl):
    check_port_step(conv_impl, "hard", False, reference)
