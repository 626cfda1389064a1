"""PyTorch port: `M2SNetTrainer(microbatch=2)` and
`recalibrate_batch_stats` on the CPU, tiny (B = 4 samples of 3 s, 1-s
crops), against the JAX trainer on the same weights, data and starts.

- microbatch = 2: the pairs cut over the whole batch, then two chunks,
  each with its own BN batch statistics and the running ones chained:
  loss rtol 1e-4, every gradient within 1e-4 of the largest of the
  float64 `jax.grad` of the mean chunk loss, the new statistics within
  1e-5 (`check_option_step`); a batch the chunks do not divide raises;
- precise-BN over two batches against JAX's within 1e-4 relative + 1e-5
  absolute (JAX recovers each batch's statistics as (new - 0.99 old) /
  0.01, 100 times the float32 rounding); weights, Adam and
  ``num_batches_tracked`` untouched; after recalibrating on one batch the
  eval-mode forward on it equals the train-mode forward within 2e-4
  (tests/test_stage1.py:131-159), on both music paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_m2s_parity import (
    check_option_step,
    close_trees,
    jax_option_step,
    jax_starts,
)

from conductor_tpu.interop import import_m2snet
from conductor_tpu.train.m2snet_trainer import M2SNetState
from conductor_tpu.train.m2snet_trainer import M2SNetTrainer as JaxTrainer
from conductor_tpu_torch import M2SNetTrainer
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
from conductor_tpu_torch.models.bn import batch_statistics_only
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


def test_microbatch_step_matches_jax():
    sd, music, motion = case()
    key = jax.random.PRNGKey(7)
    reference = jax_option_step(sd, music, motion, key, "hard", S, C, microbatch=2)
    tr = port(sd, microbatch=2)
    got = tr.train_step(music, motion, "hard", starts=jax_starts(key, "hard", S, C))
    check_option_step(tr, got, reference)
    # the running statistics moved once a forward of each chunk
    assert int(tr.model.music_encoder.conv4[1].num_batches_tracked) == 8


def test_microbatch_must_divide_the_batch():
    sd, music, motion = case()
    tr = port(sd, microbatch=2)
    with pytest.raises(ValueError, match="not divisible"):
        tr.train_step(music[:3], motion[:3], "easy", starts=(0,))
    with pytest.raises(ValueError):
        M2SNetTrainer(sample_length=S, clip_length=C, microbatch=0, device="cpu")


def test_recalibration_matches_jax():
    sd, music, motion = case()
    _, music2, motion2 = case(seed=12)
    batches = [(music, motion), (music2 * 1.5, motion2)]
    tr = port(sd)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    adam = tr.optimizer.state_dict()
    tr.recalibrate_batch_stats(batches)
    jtr = JaxTrainer(sample_length=S, clip_length=C, compute_dtype="float32",
                     music_conv_impl="lax")
    v = jax.tree.map(jnp.asarray, import_m2snet(sd))
    state = M2SNetState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=jtr.tx.init(v["params"]))
    want = jax.device_get(jtr.recalibrate_batch_stats(state, batches).batch_stats)
    after = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    close_trees(import_m2snet(after)["batch_stats"], want, rtol=1e-4, atol=1e-5)
    for k, v in before.items():
        if not k.endswith(("running_mean", "running_var")):
            assert torch.equal(tr.model.state_dict()[k], v), k
    assert tr.optimizer.state_dict() == adam


@pytest.mark.parametrize("conv_impl", ["lax", "pallas_train"])
def test_recalibrated_eval_forward_equals_the_train_forward(conv_impl):
    sd, music, motion = case()
    tr = port(sd, music_conv_impl=conv_impl)
    for _ in range(2):  # let the running statistics lag behind the weights
        tr.train_step(music, motion, "easy", starts=(0,))
    with pytest.raises(ValueError):
        tr.recalibrate_batch_stats([])
    tr.recalibrate_batch_stats([(music, motion)])
    m, p = torch.from_numpy(music), torch.from_numpy(motion)
    with torch.no_grad():
        tr.model.train()
        with batch_statistics_only():
            out_train = tr.model(m, p)
        tr.model.eval()
        out_eval = tr.model(m, p)
    np.testing.assert_allclose(out_eval.numpy(), out_train.numpy(), atol=2e-4)
