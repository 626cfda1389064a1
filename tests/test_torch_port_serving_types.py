"""PyTorch port: the mean and variance types and the quadratic attention of
serving, against the JAX package.

(a) Each (mean_type, var_type) of {start_x, epsilon, previous_x} x
    {fixed_small, fixed_large} under the ancestral sampler (and the DDIM
    ladder under the two non-START_X types) on the plain and the fused
    layers, at the size of tests/test_torch_port_serving_modes.py, held
    against JAX's generic `p_sample_loop` / `ddim_sample_loop` over JAX's
    `denoise` and JAX's `FusedDenoiser.__call__` (its K1 in interpret
    mode): not against JAX's fused `generate`, which F9 makes wrong under
    the other mean types.  JAX's per-step draws are handed over.  Bound:
    float32 atol 5e-4, rtol 1e-5 (the "epsilon" ladders reach ~600 on
    weights not trained for it).
(b) The quadratic blocks of ``efficient_attention=False`` (the CLI's
    ``--no_eff``): the reference's own output, ``out_quad`` in
    tests/fixtures/torch_transformer.npz (atol 5e-4, rtol 1e-3, as
    tests/test_torch_import.py); the attention function with a ragged key
    mask against JAX's `quadratic_self_attention` (float32, 1e-5 of the
    largest value); the module against the flax module with a ragged mask,
    float32 within 1e-5 and bf16 within 3e-2 of the largest value (JAX's
    rounding points, every output's dtype JAX's); and a plain-layer
    generate against JAX's (atol 5e-4)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.diffusion import sampling as jax_sampling
from conductor_tpu.diffusion.gaussian import MeanType, VarType
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.models import MotionTransformer as FlaxMotionTransformer
from conductor_tpu.ops.linear_attention import quadratic_self_attention as jax_quadratic
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxDDPMTrainer
from conductor_tpu.train.fused_denoiser import FusedDenoiser as JaxFusedDenoiser
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.interop import manifest, synthetic_state_dict
from conductor_tpu_torch.interop.weights import load_reference_state_dict
from conductor_tpu_torch.models.transformer import MotionTransformer, quadratic_self_attention
from test_torch_port_serving_modes import SHAPE, STEPS, case, jax_draws, make_cfg  # noqa: F401

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TYPES = [(m, v) for m in ("start_x", "epsilon", "previous_x")
         for v in ("fixed_small", "fixed_large")]
_JAX_DENOISERS = {}


def jax_denoiser(case, layer_impl):
    """JAX's denoiser on ``case``'s mel as its `generate` builds it, jitted
    once a layer path: `FusedDenoiser.__call__` or `denoise`, with the
    full src_mask."""
    if layer_impl not in _JAX_DENOISERS:
        _, state, mel, _ = case
        cfg = make_cfg(layer_impl)
        jtr = JaxDDPMTrainer(cfg)
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        xf = jtr.model.apply(variables, jnp.asarray(mel), method=jtr.model.encode_music)
        cond = dict(jtr.model.apply(variables, *xf, method=jtr.model.precompute_cond),
                    temb_table=jtr.model.apply(variables, STEPS, method=jtr.model.time_embed_table))
        if layer_impl == "pallas_fused":
            fused = JaxFusedDenoiser(state.params, cfg)
            cond = fused.prepare_cond(cond)

            def fn(x, t):
                return fused(x, t, cond)
        else:
            def fn(x, t):
                return jtr.model.apply(variables, x, t, cond, jnp.ones((1, SHAPE[1], 1)),
                                       method=jtr.model.denoise)
        _JAX_DENOISERS[layer_impl] = (jtr.sched, jax.jit(fn))
    return _JAX_DENOISERS[layer_impl]


# every type pair under the ancestral sampler on both layer paths, and the
# DDIM ladder (which reads no variance) under the two non-START_X means on
# the fused layers, where F9 gates the all-kernel ladder off
CASES = ([(layer, m, v, "ancestral") for layer in ("pallas_fused", "flax") for m, v in TYPES]
         + [("pallas_fused", m, "fixed_small", "ddim") for m in ("epsilon", "previous_x")])


@pytest.mark.parametrize("layer_impl,mean_type,var_type,sampler", CASES)
def test_types_match_jax_generic_loops(case, layer_impl, mean_type, var_type, sampler):
    sd, _, mel, rng = case
    sched, fn = jax_denoiser(case, layer_impl)
    kw = dict(mean_type=MeanType(mean_type), var_type=VarType(var_type))
    loop = jax_sampling.p_sample_loop if sampler == "ancestral" else jax_sampling.ddim_sample_loop
    want = np.asarray(loop(sched, fn, SHAPE, rng, **kw))
    port = DDPMTrainer(make_cfg(layer_impl, mean_type=mean_type, var_type=var_type), device="cpu")
    port.load_reference_state_dict(sd)
    x_t, step_noise = jax_draws(rng, STEPS)
    got = port.generate(torch.from_numpy(mel), noise=x_t, sampler=sampler,
                        step_noise=step_noise if sampler == "ancestral" else None)
    assert got.shape == want.shape == SHAPE and float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-5)


def test_quadratic_matches_reference_out_quad():
    """``efficient=False`` on the reference's key names, against the
    reference-torch output of its ``--no_eff`` model."""
    fx = np.load(os.path.join(FIXTURES, "torch_transformer.npz"))
    model = MotionTransformer(input_feats=26, num_frames=30, latent_dim=128, ff_size=64,
                              num_layers=2, num_heads=8, efficient=False).eval()
    sd = synthetic_state_dict(model, seed=0)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        xf = model.encode_music(torch.from_numpy(fx["mel"]))
        out = model(torch.from_numpy(fx["x"]), torch.from_numpy(fx["t"]).long(), *xf)
    np.testing.assert_allclose(out.numpy(), fx["out_quad"], atol=5e-4, rtol=1e-3)


def test_quadratic_attention_matches_jax():
    """The O(T^2) attention with a ragged key mask, on unit-scale q, k, v
    where masked keys would show: the mask lands on key positions."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.normal(size=(2, 24, 32)).astype(np.float32) for _ in range(3))
    mask = (np.arange(24)[None] < np.array([24, 11])[:, None]).astype(np.float32)[..., None]
    want = np.asarray(jax_quadratic(*map(jnp.asarray, (q, k, v)), 4, jnp.asarray(mask)))
    got = quadratic_self_attention(*map(torch.from_numpy, (q, k, v)), 4, torch.from_numpy(mask))
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    unmasked = quadratic_self_attention(*map(torch.from_numpy, (q, k, v)), 4, None)
    assert float((unmasked[1] - got[1]).abs().max()) > 1e-2 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quadratic_module_matches_flax(dtype):
    """`encode_music` -> `precompute_cond` -> `denoise` with a ragged key
    mask, against flax's ``MotionTransformer(efficient=False)`` at the
    same dtype; bf16 from JAX's tokens, as tests/test_torch_port_bf16_module.py."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    port = MotionTransformer(num_frames=24, num_layers=2, dtype=tdt, efficient=False).eval()
    sd = synthetic_state_dict(MotionTransformer(num_frames=24, num_layers=2), seed=5)
    load_reference_state_dict(port, sd)
    flax = FlaxMotionTransformer(num_frames=24, num_layers=2, dtype=jdt, efficient=False)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    rng = np.random.RandomState(6)
    mel = rng.uniform(0, 1, size=(2, 72, 128)).astype(np.float32)
    x = rng.normal(size=(2, 24, 26)).astype(np.float32)
    mask = (np.arange(24)[None] < np.array([24, 15])[:, None]).astype(np.float32)[..., None]
    t = np.array([3, 7], np.int32)
    xf = flax.apply(variables, jnp.asarray(mel), method=flax.encode_music)
    cond = flax.apply(variables, *xf, method=flax.precompute_cond)
    want = flax.apply(variables, jnp.asarray(x), jnp.asarray(t), cond, jnp.asarray(mask),
                      method=flax.denoise)
    tol = 1e-5 if dtype == "float32" else 3e-2
    with torch.no_grad():
        txf = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in xf]
        tcond = port.precompute_cond(*txf)
        for (gk, gv), (wk, wv) in zip(tcond["cross"], cond["cross"]):
            for g, w in ((gk, wk), (gv, wv)):
                assert str(g.dtype).split(".")[-1] == str(w.dtype)
                w = np.asarray(w, np.float32)
                assert float(np.abs(g.float().numpy() - w).max()) <= tol * float(np.abs(w).max())
        got = port.denoise(torch.from_numpy(x), torch.from_numpy(t).long(), tcond,
                           torch.from_numpy(mask))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= tol * float(np.abs(want).max())


def test_no_eff_generate_matches_jax(case):
    """A 4-step plain-layer ladder on the quadratic blocks against JAX's
    ``generate`` with ``efficient_attention=False``."""
    sd, state, mel, rng = case
    cfg = make_cfg("flax")
    cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, efficient_attention=False))
    want = np.asarray(JaxDDPMTrainer(cfg).generate(state, jnp.asarray(mel), rng, num_steps=4))
    port = DDPMTrainer(cfg, device="cpu")
    assert not port.model.efficient and port.fused is None
    assert manifest(port.model) == manifest(DDPMTrainer(make_cfg(), device="cpu").model)
    port.load_reference_state_dict(sd)
    x_t, _ = jax_draws(rng, 4)
    got = port.generate(torch.from_numpy(mel), num_steps=4, noise=x_t)
    assert got.shape == want.shape == SHAPE and float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)
