"""PyTorch port: one stage-2 step with ``replicate_reference_mask`` (the
reference's loss mask over the first min(T, m_lens) frames, also the
self-attention's key mask) against the JAX flax step, at ragged lengths
[10, 24] and T = 24, on the plain layers: 2 layers, 8 cosine steps,
cached features, JAX's t, noise and condition keep mask handed over
(`tests/test_torch_port_train_step.py`).

- float32, self-attention "xla" and "pallas" (K8's plain version against
  JAX's kernel in interpret mode): the float32 step bounds of that file,
  loss and metrics at rtol 1e-4, every parameter at atol 5e-5, rtol 5e-3;
- bf16 (flax's ``dtype=`` rule), "xla" and "pallas": the loss and each
  loss term within 3e-2 relative, the JAX bf16 loss bound
  (tests/test_fused_train_path.py:156-157).  The bf16 "pallas" step is held
  against JAX's bf16 "xla" step: JAX's K8 backward raises on the mixed
  dtypes a float32 mask gives (bf16 q, float32 k and v), so the JAX
  package has no bf16 step on its kernel to compare with.

And the mask itself: changing the motion on the masked frames leaves
``loss_mot_rec`` as it was, to the bit, while the unmasked terms move."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_port_train_step import _compare, _jax_step, _port_trainer

from conductor_tpu.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict

torch.set_num_threads(2)

B, T = 2, 24
M_LENS = np.array([10, 24])
TERMS = ("loss", "loss_mot_rec", "loss_mot_feat", "loss_velocity", "loss_head", "loss_body")


def make_cfg(dtype, impl):
    return Config(
        denoiser=DenoiserConfig(num_layers=2, num_frames=32, compute_dtype=dtype,
                                attention_impl=impl),
        diffusion=DiffusionConfig(steps=8, schedule="cosine"),
        train=TrainConfig(cached_features=True, sample_length=1, batch_size=B,
                          replicate_reference_mask=True, feat_impl="flax"),
    )


@pytest.fixture(scope="module")
def weights():
    probe = DDPMTrainer(make_cfg("float32", "xla"), device="cpu")
    rng = np.random.RandomState(3)
    return (synthetic_state_dict(probe.model, seed=1),
            synthetic_motion_encoder_state_dict(probe.feat_model, seed=2),
            rng.normal(size=(B, T, 64)).astype(np.float32),
            rng.uniform(0, 1, size=(B, T, 13, 2)).astype(np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_float32_step_matches_jax(weights, impl):
    cfg = make_cfg("float32", impl)
    jax_metrics, jax_params, drawn = _jax_step(cfg, weights, M_LENS)
    port = _port_trainer(cfg, weights)
    assert port.cfg.denoiser.train_layer_impl == "flax"  # "auto", gated off by the mask
    metrics = port.train_step(weights[2], weights[3], M_LENS, **drawn)
    _compare(port, metrics, jax_metrics, jax_params)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_step_matches_jax(weights, impl):
    jax_metrics, _, drawn = _jax_step(make_cfg("bfloat16", "xla"), weights, M_LENS)
    port = _port_trainer(make_cfg("bfloat16", impl), weights)
    assert port.model.dtype == torch.bfloat16
    metrics = port.train_step(weights[2], weights[3], M_LENS, **drawn)
    for k in TERMS:
        got, want = float(metrics[k]), jax_metrics[k]
        assert np.isfinite(got) and abs(got - want) <= 3e-2 * abs(want), (k, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_frames_do_not_reach_the_reconstruction_loss(weights, dtype):
    rng = np.random.RandomState(4)
    drawn = {"t": rng.randint(0, 8, size=B), "noise": rng.normal(size=(B, T, 26)),
             "cond_keep": np.ones((B, T), np.float32)}
    motion = weights[3]
    moved = motion.copy()
    moved[0, M_LENS[0]:] = rng.uniform(0, 1, size=moved[0, M_LENS[0]:].shape)
    cfg = make_cfg(dtype, "pallas")
    a = _port_trainer(cfg, weights).train_step(weights[2], motion, M_LENS, **drawn)
    b = _port_trainer(cfg, weights).train_step(weights[2], moved, M_LENS, **drawn)
    assert float(a["loss_mot_rec"]) == float(b["loss_mot_rec"])
    assert float(a["loss_velocity"]) != float(b["loss_velocity"])


def test_reference_mask_needs_lengths(weights):
    port = _port_trainer(make_cfg("float32", "xla"), weights)
    with pytest.raises(ValueError, match="m_lens"):
        port.train_step(weights[2], weights[3])
    cfg = make_cfg("float32", "xla")
    full = _port_trainer(cfg.replace(train=dataclasses.replace(
        cfg.train, replicate_reference_mask=False)), weights)
    assert np.isfinite(float(full.train_step(weights[2], weights[3])["loss"]))
