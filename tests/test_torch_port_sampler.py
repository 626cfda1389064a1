"""PyTorch port: the loss-second-moment timestep sampler against JAX's.

`update_state` against JAX's over batches with repeated timesteps and
full rings, exactly; `_weights` before and after warm-up at rtol 1e-6;
`loss_aware_sample`'s draw; and one stage-2 step with the sampler against
the JAX step with the sampler, JAX's t, noise and keep mask handed over, at
`test_torch_port_train_step.py`'s bounds (metrics rtol 1e-4, parameters
atol 5e-5 / rtol 5e-3), the sampler's state after the step at rtol 1e-4
(the per-sample MSE it takes is the step's float32 loss).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_step import METRICS, _batch, _compare, _port_trainer, make_cfg

from conductor_tpu.diffusion import timestep_samplers as jts
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.torch_import import import_motion_encoder
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer
from conductor_tpu_torch.diffusion import timestep_samplers as pts
from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict

torch.set_num_threads(2)


def _jax_state(state):
    return jts.SamplerState(jnp.asarray(state.loss_history), jnp.asarray(state.loss_counts))


def test_update_state_matches_jax_exactly():
    """Ten batches of 16 over 6 timesteps with a ring of 4: every ring
    fills, repeats within a batch shift it in order."""
    rng = np.random.RandomState(0)
    port = pts.init_state(6, history_per_term=4)
    ref = jts.init_state(6, history_per_term=4)
    for _ in range(10):
        t = rng.randint(0, 6, size=16)
        losses = rng.gamma(2.0, size=16).astype(np.float32)
        port = pts.update_state(port, t, losses)
        ref = jts.update_state(ref, jnp.asarray(t), jnp.asarray(losses))
        np.testing.assert_array_equal(port.loss_history, np.asarray(ref.loss_history))
        np.testing.assert_array_equal(port.loss_counts, np.asarray(ref.loss_counts))
    assert (port.loss_counts == 4).all()
    assert port.loss_history.dtype == np.float32 and port.loss_counts.dtype == np.int32


def test_weights_before_and_after_warm_up_match_jax():
    rng = np.random.RandomState(1)
    state = pts.init_state(5, history_per_term=3)
    t = np.array([0, 1, 2, 3, 4] * 2 + [0, 1, 2, 3])  # timestep 4 holds two of three
    state = pts.update_state(state, t, rng.uniform(0.1, 2.0, size=len(t)).astype(np.float32))
    for uniform_prob in (0.001, 0.2):
        w = pts._weights(state, uniform_prob)
        np.testing.assert_array_equal(w, np.full(5, 0.2, np.float32))  # not warmed up
        np.testing.assert_allclose(w, np.asarray(jts._weights(_jax_state(state), uniform_prob)),
                                   rtol=1e-6)
    state = pts.update_state(state, np.array([4]), np.array([3.0], np.float32))
    for uniform_prob in (0.001, 0.2):
        w = pts._weights(state, uniform_prob)
        want = np.asarray(jts._weights(_jax_state(state), uniform_prob))
        np.testing.assert_allclose(w, want, rtol=1e-6)
        assert w.dtype == np.float32 and not np.allclose(w, 0.2)


def test_loss_aware_sample_draws_by_the_weights():
    """t follows the weights (a chi-square bound on 20,000 draws), is
    reproducible from its generator, and the unbiasing weights are 1/(N p[t])."""
    state = pts.init_state(4, history_per_term=2)
    state = pts.update_state(state, np.array([0, 0, 1, 1, 2, 2, 3, 3]),
                             np.array([1, 1, 2, 2, 3, 3, 10, 10], np.float32))
    p = pts._weights(state, 0.001)
    t, w = pts.loss_aware_sample(state, 20000, generator=torch.Generator().manual_seed(0))
    counts = np.bincount(t.numpy(), minlength=4)
    chi2 = ((counts - 20000 * p) ** 2 / (20000 * p)).sum()
    assert chi2 < 16.3  # p = 0.001 at 3 degrees of freedom
    np.testing.assert_allclose(w.numpy(), 1.0 / (4 * p[t.numpy()]), rtol=1e-6)
    again, _ = pts.loss_aware_sample(state, 20000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(t, again)


@pytest.fixture(scope="module")
def weights():
    cfg = make_cfg("flax")
    from conductor_tpu_torch import DDPMTrainer

    probe = DDPMTrainer(cfg, device="cpu")
    sd = synthetic_state_dict(probe.model, seed=1)
    feat_sd = synthetic_motion_encoder_state_dict(probe.feat_model, seed=2)
    return (sd, feat_sd, *_batch(60))


@pytest.mark.parametrize("warm", [False, True], ids=["uniform", "warmed"])
def test_step_with_sampler_matches_jax(weights, warm):
    """One step under the loss-second-moment sampler: the JAX step draws t
    from its sampler state (uniform, or warmed up on seeded losses), the
    port is handed JAX's t, noise and keep mask and updates its state from
    its own per-sample MSE."""
    sd, feat_sd, feats, motion = weights
    b, n = motion.shape[:2]
    base = make_cfg("flax")
    cfg = base.replace(train=dataclasses.replace(base.train, timestep_sampler="loss-second-moment"))
    jtr = JaxTrainer(cfg)
    rng = jax.random.PRNGKey(0)
    state = jtr.init_state(rng)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          feat_variables=jax.tree.map(jnp.asarray, import_motion_encoder(feat_sd)),
                          opt_state=jtr.tx.init(variables["params"]))
    port = _port_trainer(cfg, weights)
    assert port.sampler_state is not None and port.sampler_state.loss_history.shape == (8, 10)
    if warm:
        seeded = np.random.RandomState(3)
        t0 = np.repeat(np.arange(8), 10)
        l0 = seeded.uniform(0.01, 1.0, size=80).astype(np.float32)
        port.sampler_state = pts.update_state(port.sampler_state, t0, l0)
        state = state.replace(sampler_state=jts.update_state(
            state.sampler_state, jnp.asarray(t0), jnp.asarray(l0)))
    # the step's random numbers, as `_train_step_impl` / `_losses` draw them
    t_rng, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
    t, _ = jts.loss_aware_sample(state.sampler_state, t_rng, b)
    noise_rng, cond_rng = jax.random.split(loss_rng)
    noise = jax.random.normal(noise_rng, (b, n, 26))
    _, ones_out = jtr.model.apply(
        {"params": state.params, "batch_stats": state.batch_stats}, jnp.ones((b, n, 64)), True,
        method=jtr.model.cond_from_features, rngs={"cond": cond_rng})
    state, jax_metrics = jtr.train_step(
        state, (jnp.asarray(feats), jnp.asarray(motion), jnp.full((b,), n, jnp.int32)), rng)
    jax_metrics = {k: float(v) for k, v in jax_metrics.items()}
    assert "mse_per_sample" not in jax_metrics

    metrics = port.train_step(feats, motion, np.full((b,), n), t=np.asarray(t),
                              noise=np.asarray(noise), cond_keep=np.asarray(ones_out[..., 0]))
    assert set(metrics) == set(METRICS) and port.step == 1
    _compare(port, metrics, jax_metrics, state.params)
    np.testing.assert_array_equal(port.sampler_state.loss_counts,
                                  np.asarray(state.sampler_state.loss_counts))
    np.testing.assert_allclose(port.sampler_state.loss_history,
                               np.asarray(state.sampler_state.loss_history), rtol=1e-4)


def test_step_draws_t_from_the_sampler(weights):
    """Without t the step draws it from the warmed sampler (one timestep
    holding all the loss) and updates the ring from its per-sample MSE."""
    sd, feat_sd, feats, motion = weights
    base = make_cfg("flax")
    cfg = base.replace(train=dataclasses.replace(base.train, timestep_sampler="loss-second-moment"))
    port = _port_trainer(cfg, weights)
    losses = np.where(np.repeat(np.arange(8), 10) == 5, 1.0, 0.0).astype(np.float32)
    port.sampler_state = pts.update_state(port.sampler_state, np.repeat(np.arange(8), 10), losses)
    port.train_step(feats, motion)
    hist = port.sampler_state.loss_history
    assert (port.sampler_state.loss_counts == 10).all()
    # both samples drew t = 5 (p = 0.999 + 0.001 / 8): the ring shifted twice
    assert (hist[5, :8] == 1.0).all() and (hist[5, 8:] != 1.0).all() and (hist[5, 8:] > 0).all()
    assert (np.delete(hist, 5, axis=0) == 0).all()
