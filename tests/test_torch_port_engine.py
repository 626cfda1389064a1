"""PyTorch port: the rest of the diffusion engine (`diffusion.gaussian`,
`diffusion.sampling`) against the JAX package's
(`conductor_tpu/diffusion/gaussian.py`, `sampling.py`), on a toy denoiser
that both packages run from the same numpy weights, with JAX's own random
draws handed over:

- DDIM at eta > 0, a step and the whole ladder (step t's noise from
  ``fold_in(loop_rng, t)``, as `_sample_loop` draws it);
- the inpainting clamp (``known_mask`` / ``known_x0``) on the DDIM and
  ancestral ladders (its noise from ``fold_in(loop_rng, t + S)``);
- `p_mean_variance` under the learned variances ("learned",
  "learned_range") and with ``clip_denoised``;
- `vb_terms_bpd` at t = 0 (the discretized decoder likelihood, with x0 on
  both edges of [-1, 1]) and t > 0 (the KL), `training_losses` for "kl",
  "rescaled_kl" and the MSE kinds' ``vb`` term under learned variances
  (its gradient reaches the variance half only), `prior_bpd` and
  `calc_bpd_loop` (its per-step noise as JAX's split chain draws it);
- the trainer still refusing the KL losses and learned variances.

Float32, within 1e-5 of the largest value.  B = 2, T = 6, 26 channels,
an 8-step cosine schedule (respaced to 4 for the ladders).  The bound's
terms are taken off the tails of tanh (`NEAR`), where float32 cannot
decide them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.diffusion import gaussian as jg
from conductor_tpu.diffusion import sampling as js
from conductor_tpu.diffusion.gaussian import LossKind, MeanType, VarType
from conductor_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from conductor_tpu.diffusion.schedule import respaced_schedule as jax_respaced
from conductor_tpu.diffusion.schedule import space_timesteps as jax_space
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig
from conductor_tpu_torch.diffusion import (
    calc_bpd_loop,
    ddim_sample_loop,
    ddim_step,
    make_schedule,
    p_mean_variance,
    p_sample_loop,
    prior_bpd,
    respaced_schedule,
    space_timesteps,
    training_losses,
    vb_terms_bpd,
)

torch.set_num_threads(2)

B, T, C, STEPS = 2, 6, 26, 8
SHAPE = (B, T, C)
# the bound's models predict x0 within ~1e-3 at t = 0: a mean several
# standard deviations from x0 puts the decoder term in the tails of tanh,
# where 1 + tanh cancels and two float32 tanh (XLA's rounds to -1 sooner
# than torch's) give cdfs of 0 and 6e-8, logs of -27.6 and -16.6
NEAR = 1e-3


def close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * max(float(np.abs(want).max()), 1e-6))


def toy(width=1, seed=0, near=0.0):
    """(port model_fn, JAX model_fn): a tanh of a linear map of x plus a
    timestep code, ``width`` x 26 channels out, from the same weights.
    With ``near`` the mean half is x plus ``near`` times that tanh: a
    start_x model close to x_t, which at t = 0 is close to x0."""
    rng = np.random.RandomState(seed)
    w = (rng.normal(size=(C, width * C)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(width * C,)) * 0.1).astype(np.float32)
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    jw, jv = jnp.asarray(w), jnp.asarray(v)
    pad = [(0, 0)] * 2 + [(0, (width - 1) * C)]

    def port(x, t):
        y = torch.tanh(x @ tw + t.to(x.dtype)[:, None, None] * 0.01 * tv)
        return y if not near else near * y + torch.nn.functional.pad(x, (0, (width - 1) * C))

    def jaxf(x, t):
        y = jnp.tanh(x @ jw + t.astype(x.dtype)[:, None, None] * 0.01 * jv)
        return y if not near else near * y + jnp.pad(x, pad)

    return port, jaxf


def scheds(steps=None):
    if steps is None:
        return make_schedule("cosine", STEPS), jax_make_schedule("cosine", STEPS)
    spaced = f"ddim{steps}"
    return (respaced_schedule("cosine", STEPS, space_timesteps(STEPS, spaced)),
            jax_respaced("cosine", STEPS, jax_space(STEPS, spaced)))


def data(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    x0 = np.clip(rng.uniform(-1.2, 1.2, size=SHAPE), -1, 1).astype(np.float32)  # edges hit
    return x, x0


def jax_ladder_draws(rng, s):
    """JAX's x_T, step noise (fold_in(loop_rng, t)) and clamp noise
    (fold_in(loop_rng, t + S)), each (S, ...) in ladder order t = S-1 .. 0."""
    init_rng, loop_rng = jax.random.split(rng)
    x_t = np.array(jax.random.normal(init_rng, SHAPE))
    ts = range(s - 1, -1, -1)
    step = np.stack([np.array(jax.random.normal(jax.random.fold_in(loop_rng, t), SHAPE))
                     for t in ts])
    known = np.stack([np.array(jax.random.normal(jax.random.fold_in(loop_rng, t + s), SHAPE))
                      for t in ts])
    return x_t, step, known


@pytest.mark.parametrize("eta", [0.5, 1.0])
def test_ddim_eta_step_matches_jax(eta):
    (ps, js_), (pf, jf) = scheds(4), toy()
    x, _ = data()
    t = np.array([3, 1])
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, SHAPE))
    want, want_x0 = js.ddim_step(js_, jf, jnp.asarray(x), jnp.asarray(t), key, eta=eta)
    got, got_x0 = ddim_step(ps, pf, torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(noise), eta=eta)
    close(got, want)
    close(got_x0, want_x0)
    # t = 0 adds no noise; eta = 0 needs none
    t0 = np.array([0, 0])
    want0, _ = js.ddim_step(js_, jf, jnp.asarray(x), jnp.asarray(t0), key, eta=eta)
    close(ddim_step(ps, pf, torch.from_numpy(x), torch.from_numpy(t0),
                    torch.from_numpy(noise), eta=eta)[0], want0)
    with pytest.raises(ValueError, match="noise"):
        ddim_step(ps, pf, torch.from_numpy(x), torch.from_numpy(t), eta=eta)


@pytest.mark.parametrize("mean_type", ["start_x", "epsilon"])
def test_ddim_eta_ladder_matches_jax(mean_type):
    (ps, js_), (pf, jf) = scheds(4), toy()
    rng = jax.random.PRNGKey(11)
    x_t, step, _ = jax_ladder_draws(rng, 4)
    want = js.ddim_sample_loop(js_, jf, SHAPE, rng, eta=1.0, mean_type=MeanType(mean_type))
    got = ddim_sample_loop(ps, pf, torch.from_numpy(x_t), eta=1.0,
                           step_noise=torch.from_numpy(step), mean_type=mean_type)
    close(got, want)
    eta0 = ddim_sample_loop(ps, pf, torch.from_numpy(x_t), mean_type=mean_type)
    assert float((got - eta0).abs().max()) > 1e-3  # the noise moved it
    with pytest.raises(ValueError, match="step_noise"):
        ddim_sample_loop(ps, pf, torch.from_numpy(x_t), step_noise=torch.from_numpy(step))
    with pytest.raises(ValueError, match="step_noise"):
        ddim_sample_loop(ps, pf, torch.from_numpy(x_t), eta=1.0,
                         step_noise=torch.from_numpy(step[:3]))


@pytest.mark.parametrize("sampler", ["ddim", "ddim_eta", "ancestral"])
def test_inpainting_clamp_matches_jax(sampler):
    """Where ``known_mask`` holds, x_t is replaced by q(x_t | known_x0) with
    JAX's clamp draws before each step."""
    (ps, js_), (pf, jf) = scheds(4), toy(seed=3)
    rng = jax.random.PRNGKey(5)
    x_t, step, known = jax_ladder_draws(rng, 4)
    _, x0 = data(seed=2)
    mask = np.zeros(SHAPE, bool)
    mask[:, :2] = True  # a known prefix (the reference's pre_seq)
    mask[1, :, 4:8] = True  # keyframe channels (transl_req)
    kw_j = dict(known_mask=jnp.asarray(mask), known_x0=jnp.asarray(x0))
    kw_p = dict(known_mask=torch.from_numpy(mask), known_x0=torch.from_numpy(x0),
                known_noise=torch.from_numpy(known))
    if sampler == "ancestral":
        want = js.p_sample_loop(js_, jf, SHAPE, rng, **kw_j)
        got = p_sample_loop(ps, pf, torch.from_numpy(x_t), step_noise=torch.from_numpy(step),
                            **kw_p)
    else:
        eta = 1.0 if sampler == "ddim_eta" else 0.0
        want = js.ddim_sample_loop(js_, jf, SHAPE, rng, eta=eta, **kw_j)
        got = ddim_sample_loop(ps, pf, torch.from_numpy(x_t), eta=eta,
                               step_noise=torch.from_numpy(step) if eta else None, **kw_p)
    close(got, want)
    free = ddim_sample_loop(ps, pf, torch.from_numpy(x_t))
    assert float((got - free).abs().max()) > 1e-3
    drawn = ddim_sample_loop(ps, pf, torch.from_numpy(x_t), known_mask=torch.from_numpy(mask),
                             known_x0=torch.from_numpy(x0),
                             generator=torch.Generator().manual_seed(0))
    assert drawn.shape == SHAPE and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("var_type", ["learned", "learned_range"])
@pytest.mark.parametrize("mean_type", ["start_x", "epsilon", "previous_x"])
@pytest.mark.parametrize("clip", [False, True])
def test_p_mean_variance_learned_matches_jax(var_type, mean_type, clip):
    (ps, js_), (pf, jf) = scheds(), toy(width=2, seed=4)
    x, _ = data(seed=3)
    t = np.array([5, 0])
    want = jg.p_mean_variance(js_, jf, jnp.asarray(x), jnp.asarray(t),
                              mean_type=MeanType(mean_type), var_type=VarType(var_type),
                              clip_denoised=clip)
    got = p_mean_variance(ps, pf, torch.from_numpy(x), torch.from_numpy(t),
                          mean_type=mean_type, var_type=var_type, clip_denoised=clip)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("var_type", ["fixed_small", "learned_range"])
def test_vb_terms_bpd_matches_jax_at_t0_and_later(var_type):
    width = 2 if var_type == "learned_range" else 1
    (ps, js_), (pf, jf) = scheds(), toy(width=width, seed=5, near=NEAR)
    noise, x0 = data(seed=4)
    assert (np.abs(x0) == 1).any()  # the decoder term's two edges
    for t in (np.array([0, 0]), np.array([3, 7]), np.array([0, 4])):
        # x_t drawn from q(x_t | x0), as the losses and the bound draw it
        x = np.array(jg.q_sample(js_, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
        want = jg.vb_terms_bpd(js_, jf, jnp.asarray(x0), jnp.asarray(x), jnp.asarray(t),
                               var_type=VarType(var_type))
        got = vb_terms_bpd(ps, pf, torch.from_numpy(x0), torch.from_numpy(x),
                           torch.from_numpy(t), var_type=var_type)
        close(got[0], want[0])
        close(got[1], want[1])


@pytest.mark.parametrize("loss_type,var_type", [
    ("kl", "fixed_small"), ("rescaled_kl", "learned_range"), ("kl", "learned"),
    ("mse", "learned_range"), ("rescaled_mse", "learned"), ("mse", "learned"),
])
def test_training_losses_kl_and_vb_match_jax(loss_type, var_type):
    width = 1 if var_type == "fixed_small" else 2
    (ps, js_), (pf, jf) = scheds(), toy(width=width, seed=6, near=NEAR)
    x, x0 = data(seed=5)
    t = np.array([0, 5])
    want = jg.training_losses(js_, jf, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(x),
                              var_type=VarType(var_type), loss_kind=LossKind(loss_type))
    got = training_losses(ps, pf, torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(x),
                          var_type=var_type, loss_type=loss_type)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


def test_vb_term_trains_the_variance_half_only():
    """Under a learned variance the MSE kinds' ``vb`` term sees the mean's
    output detached: its gradient reaches the variance half only."""
    ps = make_schedule("cosine", STEPS)
    x, x0 = data(seed=6)
    out = torch.from_numpy(np.random.RandomState(7).normal(size=(B, T, 2 * C)).astype(
        np.float32) * 0.1).requires_grad_(True)
    terms = training_losses(ps, lambda *_: out, torch.from_numpy(x0), torch.tensor([2, 6]),
                            torch.from_numpy(x), var_type="learned_range")
    terms["vb"].sum().backward()
    assert not out.grad[..., :C].any() and out.grad[..., C:].abs().sum() > 0


def test_prior_bpd_and_calc_bpd_loop_match_jax():
    """On a toy model of doubled width ("learned_range"): the prior term,
    and the whole bound with JAX's per-step noise (its split chain) handed
    over: total, prior, and the (B, T) vb / xstart_mse / mse, t
    descending."""
    (ps, js_), (pf, jf) = scheds(), toy(width=2, seed=8, near=NEAR)
    _, x0 = data(seed=8)
    close(prior_bpd(ps, torch.from_numpy(x0)), jg.prior_bpd(js_, jnp.asarray(x0)))
    rng = jax.random.PRNGKey(3)
    want = jg.calc_bpd_loop(js_, jf, jnp.asarray(x0), rng, var_type=VarType.LEARNED_RANGE)
    draws, carry = [], rng
    for _ in range(STEPS):
        rng_t, carry = jax.random.split(carry)
        draws.append(np.array(jax.random.normal(rng_t, SHAPE, jnp.float32)))
    got = calc_bpd_loop(ps, pf, torch.from_numpy(x0), noise=torch.from_numpy(np.stack(draws)),
                        var_type="learned_range")
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    assert got["vb"].shape == (B, STEPS)
    drawn = calc_bpd_loop(ps, pf, torch.from_numpy(x0), generator=torch.Generator().manual_seed(1),
                          var_type="learned_range")
    assert bool(torch.isfinite(drawn["total_bpd"]).all())


@pytest.mark.parametrize("change", [dict(loss_type="kl"), dict(loss_type="rescaled_kl"),
                                    dict(var_type="learned"), dict(var_type="learned_range")])
def test_trainer_still_refuses_them(change):
    cfg = Config(denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16, num_layers=2,
                                         num_heads=4),
                 diffusion=DiffusionConfig(steps=STEPS, schedule="cosine"))
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, **change))
    with pytest.raises(NotImplementedError, match="DDPMTrainer"):
        DDPMTrainer(cfg, device="cpu")


def test_generate_eta_runs_the_generic_loop_on_the_fused_layers(monkeypatch):
    """`generate(..., eta=1)`: on the fused layers the generic loop over
    `FusedDenoiser.__call__` (never the all-kernel ladder, whose affine is
    eta = 0's), equal to `ddim_sample_loop` over that call with the same
    step noise, and within 1e-5 of the plain layers' ladder; eta = 0 with
    step noise is refused."""
    from conductor_tpu_torch.interop import synthetic_state_dict
    from conductor_tpu_torch.train.fused_denoiser import FusedDenoiser

    def trainer(layer_impl):
        cfg = Config(denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16,
                                             num_layers=2, num_heads=4, layer_impl=layer_impl),
                     diffusion=DiffusionConfig(steps=STEPS, schedule="cosine"))
        tr = DDPMTrainer(cfg, device="cpu")
        tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=3))
        return tr

    fused, plain = trainer("pallas_fused"), trainer("flax")
    rng = np.random.RandomState(9)
    mel = torch.from_numpy(rng.uniform(0, 1, (1, 96, 128)).astype(np.float32))
    x_t = torch.from_numpy(rng.normal(size=(1, 32, 26)).astype(np.float32))
    step = torch.from_numpy(rng.normal(size=(4, 1, 32, 26)).astype(np.float32))
    monkeypatch.setattr(FusedDenoiser, "ddim_sample", None)  # the ladder must not run
    got = fused.generate(mel, num_steps=4, noise=x_t, eta=1.0, step_noise=step)
    want = plain.generate(mel, num_steps=4, noise=x_t, eta=1.0, step_noise=step)
    close(got, want.numpy())
    assert float((got - plain.generate(mel, num_steps=4, noise=x_t)).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="step_noise"):
        plain.generate(mel, num_steps=4, noise=x_t, step_noise=step)
