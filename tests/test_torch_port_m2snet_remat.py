"""PyTorch port: `M2SNetTrainer(remat=True)` on the CPU, tiny (B = 4
samples of 3 s, 1-s crops).

- against the port's own step without remat, on both music paths and
  with ``share_encodes``: the forwards really run again in the backward
  (the music encoder is called twice as often), the loss is equal, the
  BatchNorm running statistics and ``num_batches_tracked`` bit for bit (a
  recomputation that moved them again would fail here), the gradients
  within 0.005 of the largest (JAX's bound, tests/test_stage1.py:101-129);
- against the JAX trainer's remat step on the same weights, data and
  starts: loss rtol 1e-4, every gradient within 1e-4 of the largest of
  the float64 `jax.grad` of its loss, the new statistics within 1e-5
  (the step tests' bounds, `check_option_step`).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_port_m2s_parity import check_option_step, jax_option_step, jax_starts

from conductor_tpu_torch import M2SNetTrainer
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet

torch.set_num_threads(2)

S, C, B = 3, 1, 4


def case(seed=11):
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=0)
    rng = np.random.RandomState(seed)
    music = rng.normal(size=(B, S * 90, 128)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(B, S * 30, 13, 2)).astype(np.float32)
    return sd, music, motion


def port(sd, **kw):
    tr = M2SNetTrainer(sample_length=S, clip_length=C, device="cpu", **kw)
    tr.load_reference_state_dict(sd)
    return tr


@pytest.mark.parametrize("conv_impl,share", [("lax", False), ("pallas_train", False),
                                             ("lax", True)])
def test_remat_step_equals_the_plain_step(conv_impl, share):
    sd, music, motion = case()
    trainers = {r: port(sd, music_conv_impl=conv_impl, share_encodes=share, remat=r)
                for r in (False, True)}
    calls, metrics = {}, {}
    for r, tr in trainers.items():
        calls[r] = 0

        def count(*_, r=r):
            calls[r] += 1

        tr.model.music_encoder.register_forward_hook(count)
        metrics[r] = tr.train_step(music, motion, "hard", starts=(10, 50))
    assert calls == {False: 2 if share else 4, True: 4 if share else 8}
    assert float(metrics[True]["loss"]) == float(metrics[False]["loss"])
    plain, remat = (dict(trainers[r].model.named_buffers()) for r in (False, True))
    for name, v in plain.items():
        assert torch.equal(remat[name], v), name
    assert int(remat["music_encoder.conv1.0.conv2d_layer.1.num_batches_tracked"]) == (2 if share else 4)
    grads = {r: {n: p.grad for n, p in trainers[r].model.named_parameters() if p.grad is not None}
             for r in (False, True)}
    assert grads[True].keys() == grads[False].keys()
    gmax = max(float(g.abs().max()) for g in grads[False].values())
    for name, g in grads[False].items():
        np.testing.assert_allclose(grads[True][name].numpy(), g.numpy(), atol=0.005 * gmax,
                                   err_msg=name)


def test_remat_step_matches_jax():
    sd, music, motion = case()
    key = jax.random.PRNGKey(5)
    reference = jax_option_step(sd, music, motion, key, "hard", S, C, remat=True)
    tr = port(sd, remat=True)
    got = tr.train_step(music, motion, "hard", starts=jax_starts(key, "hard", S, C))
    check_option_step(tr, got, reference)
    assert tr.step == 1
