"""PyTorch port: the stage-1 GAN losses (`train.losses`), the feature
stacks they read (`M2SNet.features`) and the trainer's RMSprop
(`train.optim.RMSprop`), against the JAX package on the CPU, float32.

- each of the five gradient-penalty terms, and all five at once, and the
  penalty's gradient with respect to the critic's parameters (a double
  backward), against `conductor_tpu.train.losses.gradient_penalty` and its
  `jax.grad` in float64 under `jax.enable_x64`, the interpolation weights
  handed over (its key splits replayed, `losses.py:66-72`); the trainer's
  'real_fake' also in float32, its gradient within 1e-4 of the float64
  one's largest value;
- `M2SNet.features` on both music paths against the flax module's, and
  `sync_loss` / `feature_matching_loss` on the ST-GCN's stack, with their
  gradients to the fake;
- RMSprop against ``optax.rmsprop(5e-4, decay=0.99, eps=1e-8)`` over 3
  steps, where `torch.optim.RMSprop` departs from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_m2s_parity import as_reference, close_trees, tree

from conductor_tpu.interop import import_m2snet
from conductor_tpu.interop.torch_import import import_discriminator
from conductor_tpu.models.generator import Discriminator1DCNN as FlaxD
from conductor_tpu.models.m2snet import M2SNet as FlaxM2SNet
from conductor_tpu.models.stgcn import MotionEncoderSTGCN as FlaxSTGCN
from conductor_tpu.train import losses as jax_losses
from conductor_tpu_torch.interop import (
    load_m2snet_state_dict,
    synthetic_discriminator_state_dict,
    synthetic_m2snet_state_dict,
)
from conductor_tpu_torch.models.generator import Discriminator1DCNN
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.train.losses import (
    ALPHA_TERMS,
    GP_TERMS,
    feature_matching_loss,
    gradient_penalty,
    sync_loss,
)
from conductor_tpu_torch.train.optim import RMSprop

torch.set_num_threads(2)

B, T = 2, 180


def motion_pair():
    rng = np.random.RandomState(5)
    real = rng.uniform(0, 1, size=(B, T, 13, 2)).astype(np.float32)
    fake = rng.uniform(0.3, 0.7, size=(B, T, 13, 2)).astype(np.float32)
    return real, fake


def critic(dtype=torch.float32):
    d = Discriminator1DCNN(dtype=dtype)
    d.load_state_dict({k: torch.from_numpy(v)
                       for k, v in synthetic_discriminator_state_dict(d, seed=1).items()})
    return d, tree(jax.tree.map(np.array, import_discriminator(as_reference(d, d.state_dict()))))


def jax_alpha(rng, terms):
    """The weights `gradient_penalty` draws from ``rng`` for ``terms``."""
    out = {}
    for t in ALPHA_TERMS:
        if t in terms:
            rng, key = jax.random.split(rng)
            out[t] = np.asarray(jax.random.uniform(key, (B, 1, 1, 1) if t == "real_fake" else ()))
    return out


def jax_float64_penalty(d_vars, terms, alpha, monkeypatch):
    """`gradient_penalty` of the flax critic in float64 under
    `jax.enable_x64` and its gradient to the critic's parameters, its draws
    replaced by ``alpha``."""
    real, fake = (jnp.asarray(a, jnp.float64) for a in motion_pair())
    queue = [alpha[t] for t in ALPHA_TERMS if t in terms]
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *_, **__: jnp.asarray(queue.pop(0), jnp.float64))
    D = FlaxD(dtype=jnp.float64)
    value, grads = jax.value_and_grad(lambda p: jax_losses.gradient_penalty(
        lambda x: D.apply({"params": p}, x), real, fake, jax.random.PRNGKey(11), terms))(
        jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), d_vars["params"]))
    monkeypatch.undo()
    return float(value), jax.device_get(grads)


def port_penalty(d, terms, alpha, dtype):
    """The port's penalty and its gradient to the critic's parameters (a
    double backward), zero where a parameter does not reach it (the last
    bias)."""
    real, fake = (torch.from_numpy(a).to(dtype) for a in motion_pair())
    gp = gradient_penalty(d, real, fake, terms, {k: torch.from_numpy(v) for k, v in alpha.items()})
    names, params = zip(*d.named_parameters())
    grads = torch.autograd.grad(gp, params, allow_unused=True)
    return gp, {n: torch.zeros_like(p) if g is None else g
                for n, p, g in zip(names, params, grads)}


@pytest.mark.parametrize("terms", [(t,) for t in GP_TERMS] + [GP_TERMS],
                         ids=list(GP_TERMS) + ["all"])
def test_gradient_penalty_terms_match_jax(terms, monkeypatch):
    """The penalty and its critic gradient against JAX's in float64 on both
    sides (the port's critic with ``dtype=float64``), where the formula
    alone decides: within 1e-9 relative, and 1e-6 of the largest
    gradient.  In float32 the two frameworks' convolutions round apart, and
    on this data a window of the critic's second pool whose two largest
    values are within that rounding of each other routes the 'real_fake'
    gradient through another frame."""
    rng = jax.random.PRNGKey(11)
    alpha = jax_alpha(rng, terms)
    d, d_vars = critic(torch.float64)
    got, got_grads = port_penalty(d, terms, alpha, torch.float64)
    with jax.enable_x64(True):
        want, want_grads = jax_float64_penalty(d_vars, terms, alpha, monkeypatch)
    np.testing.assert_allclose(float(got), want, rtol=1e-9)
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(want_grads))
    close_trees(import_discriminator(as_reference(d, got_grads))["params"], want_grads,
                atol=1e-6 * gmax)


def test_gradient_penalty_float32_matches_jax(monkeypatch):
    """The trainer's term, 'real_fake', in float32 (the trainer's critic)
    against JAX's float32 value with its own draw, and its critic gradient
    within 1e-4 of the largest of JAX's float64 one; drawn weights give a
    finite penalty."""
    rng = jax.random.PRNGKey(11)
    terms = ("real_fake",)
    alpha = jax_alpha(rng, terms)
    d, d_vars = critic()
    real, fake = motion_pair()
    D = FlaxD()
    want = jax.jit(lambda r, f: jax_losses.gradient_penalty(lambda x: D.apply(d_vars, x), r, f,
                                                            rng, terms))(
        jnp.asarray(real), jnp.asarray(fake))
    got, got_grads = port_penalty(d, terms, alpha, torch.float32)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    with jax.enable_x64(True):
        _, want_grads = jax_float64_penalty(d_vars, terms, alpha, monkeypatch)
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(want_grads))
    close_trees(import_discriminator(as_reference(d, got_grads))["params"], want_grads,
                atol=1e-4 * gmax)
    drawn = gradient_penalty(d, torch.from_numpy(real), torch.from_numpy(fake), GP_TERMS,
                             generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(drawn))


@pytest.fixture(scope="module")
def m2snet_pair():
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=0)
    return sd, tree(import_m2snet(sd))


@pytest.mark.parametrize("conv_impl", ["lax", "pallas_train"])
def test_m2snet_features_match_flax(m2snet_pair, conv_impl):
    """Both encoders' stacks in eval mode: 5 music maps (the mel, the two
    first pooled maps frequency-major, the third channel-major, the
    latents) and 12 motion maps (the normalised input, 10 blocks, the
    latents)."""
    sd, variables = m2snet_pair
    model = M2SNet(music_conv_impl=conv_impl)
    load_m2snet_state_dict(model, sd)
    model.eval()
    real, _ = motion_pair()
    mel = np.random.RandomState(3).uniform(0, 1, size=(B, 3 * T, 128)).astype(np.float32)
    flax_model = FlaxM2SNet()
    want_music, want_motion = jax.jit(lambda m, x: flax_model.apply(
        variables, m, x, method=flax_model.features))(jnp.asarray(mel), jnp.asarray(real))
    with torch.no_grad():
        music, motion = model.features(torch.from_numpy(mel), torch.from_numpy(real))
    assert (len(music), len(motion)) == (len(want_music), len(want_motion)) == (5, 12)
    for got, want in zip(music + motion, list(want_music) + list(want_motion)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("loss_name", ["sync_loss", "feature_matching_loss"])
def test_perceptual_losses_match_jax(m2snet_pair, loss_name):
    """The loss on the frozen ST-GCN's feature stack and its gradient to
    the fake, the real's stack without gradient."""
    sd, variables = m2snet_pair
    model = M2SNet()
    load_m2snet_state_dict(model, sd)
    encoder = model.motion_encoder.freeze()
    real, fake = motion_pair()
    enc_vars = {"params": variables["params"]["motion_encoder"],
                "batch_stats": variables["batch_stats"]["motion_encoder"]}
    flax_stgcn = FlaxSTGCN()
    jax_fn = getattr(jax_losses, loss_name)
    want, want_grad = jax.jit(jax.value_and_grad(lambda f, r: jax_fn(
        lambda x: flax_stgcn.apply(enc_vars, x, method=flax_stgcn.features), f, r)))(
        jnp.asarray(fake), jnp.asarray(real))
    f = torch.from_numpy(fake).requires_grad_(True)
    # the port's sync_loss takes the last feature's function, JAX's the stack's
    loss_fn, features_fn = {"sync_loss": (sync_loss, lambda x: encoder.features(x)[-1]),
                            "feature_matching_loss": (feature_matching_loss, encoder.features)
                            }[loss_name]
    got = loss_fn(features_fn, f, torch.from_numpy(real))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(f.grad.numpy(), want_grad, atol=1e-4 * np.abs(want_grad).max())


def test_rmsprop_matches_optax_and_torch_rmsprop_does_not():
    """Three updates of `RMSprop` against optax's, from the same gradients;
    `torch.optim.RMSprop` (alpha 0.99, eps 1e-8) divides by sqrt(nu) +
    eps, which moves a parameter whose gradients are near 1e-4 visibly
    apart."""
    rng = np.random.RandomState(2)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [(rng.normal(size=(64,)) * np.logspace(-6, 0, 64)).astype(np.float32)
             for _ in range(3)]
    tx = optax.rmsprop(5e-4, decay=0.99, eps=1e-8)
    want, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    ours = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    theirs = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, torch_opt = RMSprop([ours], 5e-4), torch.optim.RMSprop([theirs], lr=5e-4, alpha=0.99,
                                                                eps=1e-8)
    for g in grads:
        u, state = tx.update(jnp.asarray(g), state, want)
        want = optax.apply_updates(want, u)
        ours.grad = torch.from_numpy(g)
        opt.step()
        assert ours.grad is None
        theirs.grad = torch.from_numpy(g)
        torch_opt.step()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(want), rtol=0, atol=1e-7)
    moved = np.abs(np.asarray(want) - p0).max()
    assert np.abs(theirs.detach().numpy() - np.asarray(want)).max() > 0.1 * moved
