"""PyTorch port: the MusicEncoder (float32 and, as the stage-2 trainer runs
it frozen, bf16), the fused conv block's plain version (the CPU side of
kernel K4) and the FusedMusicEncoder, against the recorded reference-torch
latents and the JAX package (Pallas in interpret mode)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.interop import import_music_encoder
from conductor_tpu.interop.synth import manifest_from_json, synth_state_dict
from conductor_tpu.models.music_encoder import FusedMusicEncoder as JaxFusedMusicEncoder
from conductor_tpu.models.music_encoder import MusicEncoder as JaxMusicEncoder
from conductor_tpu.ops.pallas_conv import fused_conv_block as jax_fused_conv_block
from conductor_tpu_torch.interop import load_reference_state_dict
from conductor_tpu_torch.models.music_encoder import POOLS, FusedMusicEncoder, MusicEncoder
from conductor_tpu_torch.ops.conv_block import fused_conv_block

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def m2snet():
    fx = np.load(os.path.join(FIXTURES, "torch_m2snet.npz"))
    sd = synth_state_dict(manifest_from_json(bytes(fx["manifest"]).decode()), seed=0)
    enc = MusicEncoder().eval()
    load_reference_state_dict(
        enc, {k[len("music_encoder."):]: v for k, v in sd.items() if k.startswith("music_encoder.")}
    )
    return fx, sd, enc


def test_music_encoder_matches_reference(m2snet):
    """Recorded reference-torch music latents `hx` (bound of
    tests/test_torch_import.py)."""
    fx, _, enc = m2snet
    with torch.no_grad():
        hx = enc(torch.from_numpy(fx["mel"]))
    np.testing.assert_allclose(hx.numpy(), fx["hx"], atol=2e-4, rtol=1e-3)


# (Cin, Cout, F, T, res_mode, pool, B): every residual mode and every pool
# configuration of the encoder, at its real channel and frequency widths,
# and two pooled blocks of one clip at a ragged T (conv1's pool at T = 37,
# conv2's stride-3 pool at T = 31), shapes the card tests hold the kernel to
BLOCKS = [
    (1, 16, 128, 12, 0, None, 2),
    (16, 16, 128, 12, 1, POOLS["conv1"], 2),
    (16, 32, 64, 12, 2, None, 2),
    (32, 32, 64, 30, 1, POOLS["conv2"], 2),
    (32, 32, 32, 10, 1, POOLS["conv3"], 2),
    (16, 16, 128, 37, 1, POOLS["conv1"], 1),
    (32, 32, 64, 31, 1, POOLS["conv2"], 1),
]
# ids from the first six columns, as pytest names such tuples, and B where it is not 2
BLOCK_IDS = ["-".join(map(str, blk[:5])) + ("-None" if blk[5] is None else f"-pool{i}")
             + ("" if blk[6] == 2 else f"-b{blk[6]}") for i, blk in enumerate(BLOCKS)]


@pytest.mark.parametrize("cin,cout,f,t,res_mode,pool,b", BLOCKS, ids=BLOCK_IDS)
def test_conv_block_plain_matches_jax_kernel(cin, cout, f, t, res_mode, pool, b):
    """The plain conv block against the JAX Pallas kernel (interpret mode,
    float32 operands); atol 2e-4."""
    rng = np.random.RandomState(cin + cout + f + t)
    x = rng.normal(size=(b, t, f, cin)).astype(np.float32)
    args = dict(
        kernel=rng.normal(0, 0.2, size=(3, 3, cin, cout)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, size=(cout,)).astype(np.float32),
        bias=rng.normal(0, 0.1, size=(cout,)).astype(np.float32),
    )
    if res_mode == 2:
        args.update(
            res_kernel=rng.normal(0, 0.2, size=(cin, cout)).astype(np.float32),
            res_scale=rng.uniform(0.5, 1.5, size=(cout,)).astype(np.float32),
            res_bias=rng.normal(0, 0.1, size=(cout,)).astype(np.float32),
        )
    want = jax_fused_conv_block(
        jnp.asarray(x), res_mode=res_mode, pool=pool, mxu_dtype=jnp.float32,
        **{k: jnp.asarray(v) for k, v in args.items()},
    )
    got = fused_conv_block(
        torch.from_numpy(x), res_mode=res_mode, pool=pool, mxu_dtype=torch.float32,
        **{k: torch.from_numpy(v) for k, v in args.items()},
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_fused_encoder_matches_jax_and_module(m2snet):
    """The plain FusedMusicEncoder (float32) against the JAX FusedMusicEncoder
    (Pallas interpret mode) on the same synthetic weights (atol 5e-4), and
    against the port's own unfused module."""
    _, sd, enc = m2snet
    mel = np.random.RandomState(7).uniform(0, 1, size=(2, 90, 128)).astype(np.float32)
    variables = import_music_encoder(sd, "music_encoder.")
    want = JaxFusedMusicEncoder(variables, mxu_dtype=jnp.float32)(jnp.asarray(mel))
    got = FusedMusicEncoder(enc, torch.float32)(torch.from_numpy(mel))
    assert got.shape == want.shape == (2, 30, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), enc(torch.from_numpy(mel)).numpy(), atol=5e-4)


def test_fused_encoder_bf16_drift(m2snet):
    """bf16 operands and bf16 activation storage between blocks, the kernel
    path's numerics: within 2 % of the float32 output scale (the bound of
    conductor_tpu/ops/pallas_conv.py)."""
    _, _, enc = m2snet
    mel = torch.from_numpy(np.random.RandomState(8).uniform(0, 1, size=(1, 90, 128)).astype(np.float32))
    ref = FusedMusicEncoder(enc, torch.float32)(mel)
    got = FusedMusicEncoder(enc, torch.bfloat16)(mel)
    assert float((got - ref).abs().max()) <= 0.02 * float(ref.abs().max())


def test_bf16_frozen_encoder_matches_jax_bf16_module(m2snet):
    """The frozen encoder at bf16 (the stage-2 trainer's, flax's ``dtype=``
    rule) against JAX's ``MusicEncoder(dtype=jnp.bfloat16)`` on the same
    weights, eval mode: bf16 output within 2 % of its largest value (the
    JAX package's bf16 bound, `conductor_tpu/ops/pallas_conv.py`)."""
    _, sd, enc = m2snet
    mel = np.random.RandomState(9).uniform(0, 1, size=(2, 90, 128)).astype(np.float32)
    variables = import_music_encoder(sd, "music_encoder.")
    want = JaxMusicEncoder(dtype=jnp.bfloat16).apply(variables, jnp.asarray(mel))
    low = MusicEncoder(dtype=torch.bfloat16).eval()
    low.load_state_dict(enc.state_dict())
    with torch.no_grad():
        got = low(torch.from_numpy(mel))
        ref = enc(torch.from_numpy(mel))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= 0.02 * scale
    # and bf16 is not float32: the rounding moved the output
    assert float((got.float() - ref).abs().max()) > 1e-4 * scale
