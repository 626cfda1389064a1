"""PyTorch port: the packed-weight fused sampling path.  Weight packing
against the JAX package, the plain versions of kernels K1-K3 against the
JAX Pallas kernels (interpret mode, float32 operands), and the plain
`FusedDenoiser` against flax `denoise`, on synthetic non-zero weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config, DenoiserConfig
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.synth import synth_state_dict
from conductor_tpu.ops.pallas_layer import fused_decoder_stack as jax_decoder_stack
from conductor_tpu.ops.pallas_sampler import sampler_epilogue as jax_epilogue
from conductor_tpu.ops.pallas_sampler import sampler_prologue as jax_prologue
from conductor_tpu.train import fused_denoiser as jfd
from conductor_tpu.train.ddpm_trainer import make_denoiser
from conductor_tpu_torch.interop import load_reference_state_dict, manifest
from conductor_tpu_torch.models.transformer import MotionTransformer
from conductor_tpu_torch.ops.decoder_stack import fused_decoder_stack
from conductor_tpu_torch.ops.sampler_glue import sampler_epilogue, sampler_prologue
from conductor_tpu_torch.train.fused_denoiser import (
    FusedDenoiser,
    expand_block_diag,
    pack_layer_weights,
)

torch.set_num_threads(2)

CFG = Config(denoiser=DenoiserConfig(num_frames=40, latent_dim=32, ff_size=16, num_layers=2,
                                     num_heads=4, compute_dtype="float32"))


@pytest.fixture(scope="module")
def models():
    """The port's model and the flax model on one synthetic weight set, made
    from the port model's own key/shape manifest."""
    model = MotionTransformer.from_config(CFG.denoiser).eval()
    sd = synth_state_dict(manifest(model), seed=1)
    load_reference_state_dict(model, sd)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    return model, variables


def test_pack_layer_weights_match_jax(models):
    model, variables = models
    for layer in range(CFG.denoiser.num_layers):
        with torch.no_grad():  # as serving packs
            got = pack_layer_weights(model, layer)
        want = jfd.pack_layer_weights(variables["params"], layer, CFG)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_expand_block_diag_matches_jax():
    kv = np.random.RandomState(0).normal(size=(2, 4, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        expand_block_diag(torch.from_numpy(kv)).numpy(),
        np.asarray(jfd.expand_block_diag(jnp.asarray(kv))),
    )


# the kernels' shapes for these tests: B = 2, T = 37 (ragged), D = 32, H = 4,
# L = 2, E = 128, pose 26
B, T, D, H, L, E, C = 2, 37, 32, 4, 2, 128, 26


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_decoder_stack_plain_matches_jax_kernel():
    """Plain K1 vs the JAX fused_decoder_stack (interpret, float32); atol 2e-4."""
    rng = np.random.RandomState(1)
    head = np.arange(D) // (D // H)
    seg = (head[:, None] == head[None, :]).astype(np.float32)
    vecs = _rand(rng, L, 24, D, scale=0.3)
    vecs[:, [0, 5, 8, 11, 16]] += 1.0  # LN gains around 1
    args = [
        _rand(rng, B, T, D),                        # x
        _rand(rng, B, T, E),                        # emb_act
        _rand(rng, L, B, D, D, scale=0.3) * seg,    # block-diagonal cross KV
        _rand(rng, L, 9, D, D, scale=0.2),          # mats
        vecs,
        _rand(rng, L, E, 6 * D, scale=0.05),        # adaln_w
        _rand(rng, L, 6 * D, scale=0.1),            # adaln_b
    ]
    want = jax_decoder_stack(*map(jnp.asarray, args), H, mxu_dtype=jnp.float32)
    got = fused_decoder_stack(*map(torch.from_numpy, args), H, mxu_dtype=torch.float32)
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_sampler_glue_plain_matches_jax_kernels():
    """Plain K2 / K3 vs the JAX sampler_prologue / sampler_epilogue
    (interpret, float32); atol 2e-4.  The port's prologue fuses the add of
    the time-embedding row that the JAX caller does before its kernel."""
    rng = np.random.RandomState(2)
    x, temb, emb_base = _rand(rng, B, T, C), _rand(rng, E), _rand(rng, B, T, E)
    w_joint, seq_bias = _rand(rng, C, D, scale=0.2), _rand(rng, T, D)
    h_want, emb_want = jax_prologue(
        jnp.asarray(x), jnp.asarray(temb[None, None] + emb_base), jnp.asarray(w_joint),
        jnp.asarray(seq_bias),
    )
    h, emb_act, emb_scale = sampler_prologue(
        *map(torch.from_numpy, (x, temb, emb_base, w_joint, seq_bias)))
    assert emb_scale is None
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=2e-4)
    np.testing.assert_allclose(emb_act.numpy(), np.asarray(emb_want), atol=2e-4)

    hh, w_out, b_out = _rand(rng, B, T, D), _rand(rng, D, C, scale=0.2), _rand(rng, C)
    alpha, beta = 0.7, 1.3
    want = jax_epilogue(*map(jnp.asarray, (hh, x, w_out, b_out)),
                        jnp.float32(alpha), jnp.float32(beta))
    got = sampler_epilogue(*map(torch.from_numpy, (hh, x, w_out, b_out)), alpha, beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_fused_denoiser_matches_flax_denoise(models):
    """The plain FusedDenoiser call against flax `MotionTransformer.denoise`
    on the same weights and condition."""
    model, variables = models
    flax_model = make_denoiser(CFG.replace(
        denoiser=dataclasses.replace(CFG.denoiser, layer_impl="flax", attention_impl="xla")))
    rng = np.random.RandomState(3)
    mel = rng.uniform(0, 1, size=(2, 120, 128)).astype(np.float32)
    x = rng.normal(size=(2, 40, 26)).astype(np.float32)
    t = np.array([7, 900], np.int32)
    xf_proj, xf_out = flax_model.apply(variables, jnp.asarray(mel), method=flax_model.encode_music)
    cond = flax_model.apply(variables, xf_proj, xf_out, method=flax_model.precompute_cond)
    want = flax_model.apply(variables, jnp.asarray(x), jnp.asarray(t), cond, None,
                            method=flax_model.denoise)

    fused = FusedDenoiser(model, CFG)
    with torch.no_grad():
        tcond = model.precompute_cond(*model.encode_music(torch.from_numpy(mel)))
    got = fused(torch.from_numpy(x), torch.from_numpy(t).long(), fused.prepare_cond(tcond))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)

    # bf16 operands (the kernel path's numerics) stay within 2 % of scale
    bf = FusedDenoiser(model, CFG.replace(
        denoiser=dataclasses.replace(CFG.denoiser, compute_dtype="bfloat16")))
    got_bf = bf(torch.from_numpy(x), torch.from_numpy(t).long(), bf.prepare_cond(tcond))
    assert float((got_bf - got).abs().max()) <= 0.02 * float(got.abs().max())
