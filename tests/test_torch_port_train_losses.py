"""PyTorch port: the diffusion training losses, the uniform timestep
sampler and the clip-then-Adam optimizer against the JAX package
(`conductor_tpu.diffusion`) and optax, on inputs made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conductor_tpu.diffusion import LossKind, MeanType, VarType
from conductor_tpu.diffusion import gaussian as jg
from conductor_tpu.diffusion import make_schedule as jax_make_schedule
from conductor_tpu.diffusion import timestep_samplers as jts
from conductor_tpu_torch.diffusion import make_schedule, q_sample, training_losses, uniform_sample
from conductor_tpu_torch.diffusion.timestep_samplers import init_state, loss_aware_sample
from conductor_tpu_torch.train.optim import ClippedAdam, clip_by_global_norm

torch.set_num_threads(2)


def _inputs(seed=0, b=3, n=20):
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(0, 1, size=(b, n, 13, 2)).astype(np.float32)
    noise = rng.normal(size=(b, n, 13, 2)).astype(np.float32)
    w = rng.normal(size=(26, 26)).astype(np.float32) * 0.3
    return x0, noise, w


@pytest.mark.parametrize("name,steps", [("cosine", 8), ("linear", 1000)])
def test_q_sample_matches_jax(name, steps):
    x0, noise, _ = _inputs()
    t = np.array([0, steps // 2, steps - 1], np.int64)
    want = jg.q_sample(jax_make_schedule(name, steps), jnp.asarray(x0), jnp.asarray(t),
                       jnp.asarray(noise))
    got = q_sample(make_schedule(name, steps), torch.from_numpy(x0), torch.from_numpy(t),
                   torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mean_type", ["start_x", "epsilon", "previous_x"])
def test_training_losses_match_jax(mean_type):
    """Every returned term, with the same (linear, t-dependent) model on
    both sides."""
    x0, noise, w = _inputs(1)
    t = np.array([1, 4, 7], np.int64)

    def jax_model(x, tt):
        return x.reshape(x.shape[0], x.shape[1], -1) @ w + tt[:, None, None] * 0.01

    def port_model(x, tt):
        return x.reshape(x.shape[0], x.shape[1], -1) @ torch.from_numpy(w) + tt[:, None, None] * 0.01

    want = jg.training_losses(jax_make_schedule("cosine", 8), jax_model, jnp.asarray(x0),
                              jnp.asarray(t), jnp.asarray(noise), mean_type=MeanType(mean_type),
                              var_type=VarType.FIXED_SMALL, loss_kind=LossKind.MSE)
    got = training_losses(make_schedule("cosine", 8), port_model, torch.from_numpy(x0),
                          torch.from_numpy(t), torch.from_numpy(noise), mean_type=mean_type)
    assert set(got) == set(want)
    for k in want:  # atol: float32 summation order of the O(1) matmul
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("kwargs", [{"loss_type": "kl"}, {"var_type": "learned"}])
def test_unported_losses_raise(kwargs):
    """The KL loss and the learned variances: the engine computes them
    (held against JAX in tests/test_torch_port_engine.py), and the trainer,
    whose objective is the MSE family's over a fixed variance, still
    refuses them where it is built, as JAX's does."""
    import dataclasses

    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig

    x0, noise, _ = _inputs()
    flat = torch.from_numpy(x0).reshape(3, 20, 26)
    model_fn = ((lambda x, t: torch.cat([x, torch.zeros_like(x)], -1))
                if "var_type" in kwargs else (lambda x, t: x))
    terms = training_losses(make_schedule("cosine", 8), model_fn, flat,
                            torch.zeros(3, dtype=torch.long),
                            torch.from_numpy(noise).reshape(3, 20, 26), **kwargs)
    key = "loss" if "loss_type" in kwargs else "vb"
    assert terms[key].shape == (3,) and bool(torch.isfinite(terms[key]).all())
    cfg = Config(denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16, num_layers=2,
                                         num_heads=4),
                 diffusion=DiffusionConfig(steps=8, schedule="cosine"))
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, **kwargs))
    with pytest.raises(NotImplementedError):
        DDPMTrainer(cfg, device="cpu")


def test_uniform_sample_range_matches_jax():
    """Both samplers draw every timestep of [0, N) and nothing else, with
    unit weights; the port's draw is reproducible from its generator.  So
    does the loss-second-moment sampler before its warm-up, as JAX's."""
    n, b = 8, 4096
    tj, wj = jts.uniform_sample(jax.random.PRNGKey(0), n, b)
    tp, wp = uniform_sample(n, b, generator=torch.Generator().manual_seed(0))
    assert set(np.unique(np.asarray(tj))) == set(np.unique(tp.numpy())) == set(range(n))
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))
    again, _ = uniform_sample(n, b, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tp, again)
    tj, wj = jts.loss_aware_sample(jts.init_state(n), jax.random.PRNGKey(0), b)
    tp, wp = loss_aware_sample(init_state(n), b, generator=torch.Generator().manual_seed(0))
    assert set(np.unique(np.asarray(tj))) == set(np.unique(tp.numpy())) == set(range(n))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])
def test_clip_then_adam_matches_optax(grad_scale):
    """One (then a second) step of clip_by_global_norm(0.5) + adam(2e-4)
    against optax at rtol 1e-6; grad_scale 1.0 puts the norm over 0.5."""
    rng = np.random.RandomState(2)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * grad_scale for s in shapes] for _ in range(2)]

    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2e-4))
    p_jax = [jnp.asarray(p) for p in params]
    state = tx.init(p_jax)
    p_t = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ClippedAdam(p_t, lr=2e-4, max_norm=0.5)
    for g in grads:
        g_jax = [jnp.asarray(x) for x in g]
        norm_jax = float(optax.global_norm(g_jax))
        upd, state = tx.update(g_jax, state, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        for p, x in zip(p_t, g):
            p.grad = torch.from_numpy(x.copy())
        norm = float(opt.step())
        np.testing.assert_allclose(norm, norm_jax, rtol=1e-6)
        # atol 1e-8 = 5e-5 of one 2e-4 update: for a weight near 0 the two
        # Adam formulas' float32 rounding of the update shows
        for a, b in zip(p_t, p_jax):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)
    assert (norm > 0.5) == (grad_scale == 1.0)


def test_global_norm_has_no_epsilon():
    """optax's clip divides by the bare norm; torch's clip_grad_norm_ adds 1e-6."""
    g = [torch.full((4,), 0.5)]
    clipped, norm = clip_by_global_norm(g, 0.5)
    assert float(norm) == 1.0
    assert torch.equal(clipped[0], torch.full((4,), 0.25))
    at_limit, _ = clip_by_global_norm([torch.full((4,), 0.25)], 0.5)  # norm == max: clipped
    assert torch.equal(at_limit[0], torch.full((4,), 0.25))
