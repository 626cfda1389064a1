"""PyTorch port: stage 1 at bf16 on the CPU against the JAX package's bf16
configuration, ``M2SNetTrainer(compute_dtype="bfloat16")`` on its lax
path, on the same synthetic weights, data and pair starts (B = 2, 6-s
samples, 2-s crops, strategy "easy": the shape and helpers of
tests/test_torch_port_m2s_parity.py; a crop is at most a third of a
sample).

- One step on each of the port's music paths ("lax", and "pallas_train" on
  the kernels' plain versions): the loss within 3e-2 relative, the JAX
  bf16 loss bound (tests/test_fused_train_path.py:156-157), and the
  sync / non-sync probabilities likewise.
- The music encoder alone, train mode, on one crop, and likewise the
  ST-GCN and the fusion head: each bf16 output within 2 % of the largest
  value of JAX's bf16 output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_m2s_parity import C, S, jax_starts

from conductor_tpu.interop import import_m2snet
from conductor_tpu.models.m2snet import M2SNet as JaxM2SNet
from conductor_tpu.models.music_encoder import MusicEncoder as JaxMusicEncoder
from conductor_tpu.train.m2snet_trainer import M2SNetState
from conductor_tpu.train.m2snet_trainer import M2SNetTrainer as JaxTrainer
from conductor_tpu_torch import M2SNetTrainer
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.models.music_encoder import MusicEncoder

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=0)
    rng = np.random.RandomState(12)
    music = rng.normal(size=(2, S * 90, 128)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(2, S * 30, 13, 2)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    tr = JaxTrainer(sample_length=S, clip_length=C, compute_dtype="bfloat16",
                    music_conv_impl="lax")
    v = jax.tree.map(jnp.asarray, import_m2snet(sd))
    state = M2SNetState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=tr.tx.init(v["params"]))
    _, metrics = tr.train_step(state, (jnp.asarray(music), jnp.asarray(motion)), key, "easy")
    return sd, music, motion, key, {k: float(m) for k, m in metrics.items()}


@pytest.mark.parametrize("conv_impl", ["lax", "pallas_train"])
def test_bf16_step_matches_jax_bf16_step(case, conv_impl):
    sd, music, motion, key, want = case
    tr = M2SNetTrainer(sample_length=S, clip_length=C, compute_dtype="bfloat16",
                       music_conv_impl=conv_impl, device="cpu")
    tr.load_reference_state_dict(sd)
    got = tr.train_step(torch.from_numpy(music), torch.from_numpy(motion), "easy",
                        starts=jax_starts(key, "easy", S, C))
    for k in ("loss", "sync_prob", "non_sync_prob"):
        assert np.isfinite(float(got[k]))
        assert abs(float(got[k]) - want[k]) <= 3e-2 * abs(want[k]), (k, float(got[k]), want[k])
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}


def test_bf16_music_encoder_matches_jax_in_train_mode(case):
    sd, music, _, _, _ = case
    mel = music[:, : C * 90]
    v = import_m2snet(sd)
    variables = jax.tree.map(jnp.asarray, {"params": v["params"]["music_encoder"],
                                           "batch_stats": v["batch_stats"]["music_encoder"]})
    want, _ = JaxMusicEncoder(dtype=jnp.bfloat16).apply(variables, jnp.asarray(mel), True,
                                                        mutable=["batch_stats"])
    model = M2SNet(compute_dtype=torch.bfloat16)
    model.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    enc: MusicEncoder = model.music_encoder.train()
    with torch.no_grad():
        got = enc(torch.from_numpy(mel))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    want = np.asarray(want, np.float32)
    assert float(np.abs(got.float().numpy() - want).max()) <= 0.02 * float(np.abs(want).max())


def test_bf16_motion_encoder_and_fusion_match_jax(case):
    """The ST-GCN (train mode) and the fusion head at bf16 against JAX's
    ``M2SNet(dtype=jnp.bfloat16)`` parts on one crop, each output in bf16
    as JAX's.  The fusion head within 2 % of its largest value.  The
    ST-GCN's ten blocks of train-mode BatchNorm, which divides by the batch
    deviation, take the JAX package's own bf16 encoder bound
    (tests/test_conv_train.py:253-258): mean difference under 2 % of the
    largest value, largest under 15 % (measured: 0.42 % and 3.5 %; the JAX
    module composes the graph conv into one matrix before rounding, the
    port rounds the 1x1 conv and the joint contraction apart, which keeps
    the module's FLOPs)."""
    sd, music, motion, _, _ = case
    crop = motion[:, : C * 30]
    v = jax.tree.map(jnp.asarray, import_m2snet(sd))
    flax_model = JaxM2SNet(dtype=jnp.bfloat16)
    hx = np.random.RandomState(3).normal(size=(2, C * 30, 64)).astype(np.float32)
    (hy_want, _), p_want = (
        flax_model.apply(v, jnp.asarray(crop), True, mutable=["batch_stats"],
                         method=lambda m, x, train: m.motion_encoder(x, train)),
        flax_model.apply(v, jnp.asarray(hx, jnp.bfloat16), jnp.asarray(hx[..., ::-1], jnp.bfloat16),
                         method=flax_model.fuse))
    model = M2SNet(compute_dtype=torch.bfloat16).train()
    model.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    with torch.no_grad():
        hy = model.motion_encoder(torch.from_numpy(crop))
        t_hx = torch.from_numpy(hx).to(torch.bfloat16)
        p = model.fuse(t_hx, t_hx.flip(-1))
    for got, want in ((hy, hy_want), (p, p_want)):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    diff = lambda got, want: np.abs(got.float().numpy() - np.asarray(want, np.float32))  # noqa: E731
    scale = float(np.abs(np.asarray(hy_want, np.float32)).max())
    assert float(diff(hy, hy_want).mean()) < 0.02 * scale
    assert float(diff(hy, hy_want).max()) < 0.15 * scale
    assert float(diff(p, p_want).max()) <= 0.02 * float(np.abs(np.asarray(p_want, np.float32)).max())
