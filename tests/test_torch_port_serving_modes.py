"""PyTorch port, the rest of `DDPMTrainer.generate` against the JAX package,
at the size of `serving_pair` in tests/test_torch_port_generate.py (D = 32,
2 layers, 4 heads, T = 32, 8 cosine steps, float32, one synthetic weight
set from the port model's manifest): classifier-free guidance at 2.5 on
both layer paths against JAX's ``generate(..., guidance_scale=2.5)``, the
ancestral sampler with JAX's own draws handed over (x_T from ``split(rng)
[0]``, step t's noise from ``fold_in(split(rng)[1], t)``, as
`conductor_tpu/diffusion/sampling.py:117-132` draws them), the F9 gate
(which of the all-kernel ladder and `FusedDenoiser.__call__` each call
takes; JAX's fused ladder is wrong under "epsilon", the port's call is
not), and what construction accepts and refuses.  K1 and K4 run their
plain versions here; JAX's fused path runs its Pallas kernels in interpret
mode.  Tolerance: float32 atol 5e-4, as the other serving tests, with
rtol 1e-5 where a ladder leaves unit scale ("epsilon" on weights not
trained for it reaches ~600)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu.diffusion import sampling as jax_sampling
from conductor_tpu.diffusion.gaussian import MeanType, VarType
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.synth import synth_state_dict
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxDDPMTrainer
from conductor_tpu.train.ddpm_trainer import TrainState
from conductor_tpu.train.fused_denoiser import FusedDenoiser as JaxFusedDenoiser
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.config import resolve_auto
from conductor_tpu_torch.interop import manifest
from conductor_tpu_torch.train.ddpm_trainer import _check_training_config
from conductor_tpu_torch.train.fused_denoiser import FusedDenoiser

torch.set_num_threads(2)

T, STEPS, SHAPE = 32, 8, (1, 32, 26)
GUIDANCE = 2.5  # tests/test_train_e2e.py:139


def make_cfg(layer_impl="pallas_fused", encoder="flax", **diffusion):
    return Config(
        denoiser=DenoiserConfig(num_frames=T, latent_dim=32, ff_size=16, num_layers=2,
                                num_heads=4, layer_impl=layer_impl, music_encoder_impl=encoder,
                                compute_dtype="float32"),
        diffusion=DiffusionConfig(steps=STEPS, schedule="cosine", **diffusion),
        train=TrainConfig(sample_length=1),
    )


@pytest.fixture(scope="module")
def case():
    sd = synth_state_dict(manifest(DDPMTrainer(make_cfg(), device="cpu").model), seed=2)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    # generate reads only the params and the encoder's BN statistics
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], feat_variables=None, opt_state=None)
    mel = np.random.RandomState(4).uniform(0, 1, size=(1, 3 * T, 128)).astype(np.float32)
    return sd, state, mel, jax.random.PRNGKey(0)


def jax_draws(rng, num_steps):
    """JAX's x_T and the ancestral ladder's per-step noise (S, *SHAPE), in
    ladder order (t = S-1 .. 0), as its samplers draw them."""
    init_rng, loop_rng = jax.random.split(rng)
    x_t = np.array(jax.random.normal(init_rng, SHAPE))
    step_noise = np.stack([np.array(jax.random.normal(jax.random.fold_in(loop_rng, t), SHAPE))
                           for t in range(num_steps - 1, -1, -1)])
    return torch.from_numpy(x_t), torch.from_numpy(step_noise)


def port_trainer(sd, cfg):
    tr = DDPMTrainer(cfg, device="cpu")
    tr.load_reference_state_dict(sd)
    return tr


def assert_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape == SHAPE
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-5)


# bench.py's serving config (bench.py:41-50) under guidance: port against
# JAX, of the largest value (measured: 0.0017), and each one's drift from
# JAX's float32 fused path (JAX 0.0019, the port 0.0014; 0.0031 unguided
# against JAX in tests/test_torch_port_sampler_modes.py)
BENCH = dict(attention_impl="pallas", compute_dtype="bfloat16", sampler_adaln_int8=True)
GUIDED_INT8_TOL = 0.005  # tests/test_torch_port_sampler_modes.py GEN_REL_TOL
DRIFT_TOL = 0.03  # the serving bound, tests/test_fused_denoiser.py:189-218


@pytest.mark.parametrize("layer_impl,encoder,bench", [
    pytest.param("pallas_fused", "pallas", False, id="pallas_fused-pallas"),
    pytest.param("flax", "flax", False, id="flax-flax"),
    pytest.param("pallas_fused", "pallas", True, id="bench-int8"),
])
def test_guidance_matches_jax(case, layer_impl, encoder, bench):
    """Guidance at 2.5 (the e2e test's scale) over the full 8-step ladder:
    on the fused layers two K1 calls a step (JAX: two `FusedDenoiser`
    calls, no K2 / K3) with K4 for the encoder, on the plain layers two
    `denoise` calls; and the guidance moves the motion.  Under bench.py's
    int8 config (bf16, int8 AdaLN) the port stays within 0.5 % of JAX's
    same config, and the two drift alike from JAX's float32 fused path:
    JAX's drift is the reference's, within the 3 % serving bound, and the
    port's within 0.5 % of it."""
    sd, state, mel, rng = case
    cfg = make_cfg(layer_impl, encoder)
    f32 = cfg
    if bench:
        cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, **BENCH))
    want = JaxDDPMTrainer(cfg).generate(state, jnp.asarray(mel), rng, guidance_scale=GUIDANCE)
    port = port_trainer(sd, cfg)
    x_t, _ = jax_draws(rng, STEPS)
    got = port.generate(torch.from_numpy(mel), noise=x_t, guidance_scale=GUIDANCE)
    if bench:
        assert port.fused.adaln_w.dtype == torch.int8
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= GUIDED_INT8_TOL * float(np.abs(want).max())
        exact = np.asarray(JaxDDPMTrainer(f32).generate(state, jnp.asarray(mel), rng,
                                                        guidance_scale=GUIDANCE))
        scale = float(np.abs(exact).max())
        jax_drift = float(np.abs(want - exact).max()) / scale
        port_drift = float(np.abs(got.numpy() - exact).max()) / scale
        assert 1e-5 < jax_drift <= DRIFT_TOL and abs(port_drift - jax_drift) <= GUIDED_INT8_TOL
    else:
        assert_close(got, want)
    plain = port.generate(torch.from_numpy(mel), noise=x_t)
    assert float((got - plain).abs().max()) > 1e-2


def test_ancestral_matches_jax(case):
    """The ancestral ladder on the fused layers, respaced to 4 steps, with
    JAX's x_T and per-step noise handed over; drawn from a generator it
    repeats with the seed, and a step_noise of another shape, or with the
    DDIM sampler, raises."""
    sd, state, mel, rng = case
    cfg = make_cfg()
    want = JaxDDPMTrainer(cfg).generate(state, jnp.asarray(mel), rng, num_steps=4,
                                        sampler="ancestral")
    port = port_trainer(sd, cfg)
    x_t, step_noise = jax_draws(rng, 4)
    mel_t = torch.from_numpy(mel)
    got = port.generate(mel_t, num_steps=4, noise=x_t, step_noise=step_noise, sampler="ancestral")
    assert_close(got, want)

    def drawn():
        return port.generate(mel_t, num_steps=4, sampler="ancestral",
                             generator=torch.Generator().manual_seed(7))
    assert torch.equal(drawn(), drawn())
    with pytest.raises(ValueError, match="step_noise"):
        port.generate(mel_t, num_steps=4, noise=x_t, step_noise=step_noise[:3], sampler="ancestral")
    with pytest.raises(ValueError, match="step_noise"):
        port.generate(mel_t, num_steps=4, noise=x_t, step_noise=step_noise)


@pytest.mark.parametrize("sampler,guidance,mean_type,ladder,calls", [
    ("ddim", 1.0, "start_x", 1, 0),
    ("ddim", GUIDANCE, "start_x", 0, 2 * STEPS),
    ("ancestral", 1.0, "start_x", 0, STEPS),
    ("ddim", 1.0, "epsilon", 0, STEPS),
    ("ancestral", GUIDANCE, "previous_x", 0, 2 * STEPS),
])
def test_f9_gate_routes_the_fused_layers(case, monkeypatch, sampler, guidance, mean_type, ladder,
                                         calls):
    """F9: on the fused layers only a DDIM ladder without guidance under
    "start_x" takes the all-kernel ladder (K2 -> K1 -> K3 a step);
    guidance, the ancestral sampler and the other mean types run the
    generic loop over `FusedDenoiser.__call__` (K1 alone), twice a step
    with guidance.  On the card phase 17 of chip_smoke.py shows the same in
    the launch counts."""
    sd, _, mel, _ = case
    port = port_trainer(sd, make_cfg(mean_type=mean_type))
    seen = {"ladder": 0, "calls": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(FusedDenoiser, "ddim_sample", counted("ladder", FusedDenoiser.ddim_sample))
    monkeypatch.setattr(FusedDenoiser, "__call__", counted("calls", FusedDenoiser.__call__))
    out = port.generate(torch.from_numpy(mel), noise=torch.zeros(SHAPE), sampler=sampler,
                        guidance_scale=guidance, generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(out).all())
    assert seen == {"ladder": ladder, "calls": calls}


def test_jax_fused_ladder_ignores_mean_type(case):
    """F9 itself: under "epsilon" JAX's fused `generate` takes its
    all-kernel ladder, whose affine is START_X's, so it departs from JAX's
    own generic `ddim_sample_loop` over its `FusedDenoiser.__call__`; the
    port matches the generic loop."""
    sd, state, mel, rng = case
    cfg = make_cfg(mean_type="epsilon")
    jtr = JaxDDPMTrainer(cfg)
    fused_ladder = np.asarray(jtr.generate(state, jnp.asarray(mel), rng))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    xf = jtr.model.apply(variables, jnp.asarray(mel), method=jtr.model.encode_music)
    cond = jtr.model.apply(variables, *xf, method=jtr.model.precompute_cond)
    fused = JaxFusedDenoiser(state.params, cfg)
    cond = fused.prepare_cond(dict(cond, temb_table=jtr.model.apply(
        variables, STEPS, method=jtr.model.time_embed_table)))
    generic = np.asarray(jax_sampling.ddim_sample_loop(
        jtr.sched, jax.jit(lambda x, t: fused(x, t, cond)), SHAPE, rng,
        mean_type=MeanType.EPSILON, var_type=VarType.FIXED_SMALL))
    x_t, _ = jax_draws(rng, STEPS)
    got = port_trainer(sd, cfg).generate(torch.from_numpy(mel), noise=x_t)
    assert_close(got, generic)
    scale = float(np.abs(generic).max())
    assert float(np.abs(fused_ladder - generic).max()) > 1e-2 * scale


@pytest.mark.parametrize("change,error", [
    (dict(diffusion=dict(mean_type="epsilon", var_type="fixed_large")), None),
    (dict(diffusion=dict(mean_type="previous_x")), None),
    (dict(diffusion=dict(var_type="learned")), NotImplementedError),
    (dict(diffusion=dict(var_type="learned_range")), NotImplementedError),
    (dict(diffusion=dict(mean_type="bogus")), ValueError),
    (dict(denoiser=dict(dropout=0.1)), None),
    (dict(denoiser=dict(efficient_attention=False)), ValueError),
])
def test_construction_accepts_what_jax_accepts(change, error):
    """The trainer takes JAX's mean and variance types
    (`conductor_tpu/train/ddpm_trainer.py:104-118`) and a dropout config
    (serving ignores dropout, as JAX's ``train=False`` does), and refuses
    what JAX refuses (learned variances) or the port does not run (the
    fused layers without linear attention, where JAX would silently
    compute linear attention)."""
    cfg = make_cfg()
    cfg = cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kw)
                         for sec, kw in change.items()})
    if error is None:
        assert DDPMTrainer(cfg, device="cpu").fused is not None
    else:
        with pytest.raises(error):
            DDPMTrainer(cfg, device="cpu")


def test_no_eff_auto_serves_on_the_plain_layers():
    """``efficient_attention=False`` at "auto": the plain (quadratic) layers
    on CUDA too, where "auto" otherwise picks the kernels, as JAX's rule
    does (checked without a card)."""
    cfg = make_cfg(layer_impl="auto", encoder="auto")
    cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, efficient_attention=False,
                                                   compute_dtype="auto"))
    cuda = resolve_auto(cfg, "cuda")
    assert (cuda.denoiser.layer_impl, cuda.denoiser.attention_impl) == ("flax", "xla")
    _check_training_config(cuda, torch.device("cuda"))
