"""PyTorch port: one decoder layer for training.  The plain K5
(`decoder_layer_plain`) against JAX `fused_decoder_layer`, the seven
gradients of the plain K6 path of `fused_decoder_layer_train` against JAX
`fused_decoder_layer_train` (both Pallas kernels in interpret mode, float32
operands) at the sizes and bounds of tests/test_pallas_layer_bwd.py, and
the differentiable weight pack against the module path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conductor_tpu.ops.pallas_layer import fused_decoder_layer as jax_layer
from conductor_tpu.ops.pallas_layer_bwd import fused_decoder_layer_train as jax_layer_train
from conductor_tpu_torch.config import DenoiserConfig
from conductor_tpu_torch.interop import load_reference_state_dict, synthetic_state_dict
from conductor_tpu_torch.models.transformer import MotionTransformer
from conductor_tpu_torch.ops import decoder_layer_plain, fused_decoder_layer_train, launch_counts
from conductor_tpu_torch.train.fused_denoiser import expand_block_diag, pack_layer_weights

torch.set_num_threads(2)

D, E, H = 128, 512, 8
NAMES = ["dx", "demb", "dkvc", "dmats", "dvecs", "daw", "dab"]


def make_inputs(seed, b=2, t=24):
    """tests/test_pallas_layer_bwd.py's `make_inputs`, drawn with numpy."""
    rng = np.random.RandomState(seed)

    def n(shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    vecs = n((24, D), 0.3)
    vecs[[0, 5, 8, 11, 16]] += 1.0
    return [n((b, t, D)), n((b, t, E), 0.5), n((b, D, D), 0.1), n((9, D, D), 0.08), vecs,
            n((E, 6 * D), 0.02), n((6 * D,), 0.05)]


@pytest.mark.parametrize("t,t_valid", [(24, None), (24, 21)])
def test_plain_layer_matches_jax(t, t_valid):
    args = make_inputs(0, t=t)
    want = jax_layer(*map(jnp.asarray, args), H, mxu_dtype=jnp.float32, t_valid=t_valid)
    got = decoder_layer_plain(*map(torch.from_numpy, args), H, t_valid=t_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("seed,b,t", [(1, 2, 24), (3, 1, 21)])
def test_plain_gradients_match_jax(seed, b, t):
    """All seven gradients; T = 21 is the ragged case (the JAX custom_vjp
    pads it to 24 rows and masks them)."""
    args = make_inputs(seed, b=b, t=t)
    dy = np.random.RandomState(seed + 1).normal(size=(b, t, D)).astype(np.float32)
    import jax

    g_jax = jax.grad(
        lambda *a: (jax_layer_train(*a, H, jnp.float32) * dy).sum(), argnums=tuple(range(7)),
    )(*map(jnp.asarray, args))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fused_decoder_layer_train(*inputs, H, mxu_dtype=torch.float32)
    g_port = torch.autograd.grad(out, inputs, torch.from_numpy(dy))
    for name, a, g in zip(NAMES, g_jax, g_port):
        scale = max(1.0, float(jnp.abs(a).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=3e-4 * scale, rtol=2e-3,
                                   err_msg=name)
    assert launch_counts()["decoder_layer_bwd"] == 0  # the plain path launches nothing


def test_padded_rows_carry_no_gradient():
    """Inputs padded to 64 rows with t_valid = 21 (as the training forward
    pads them) give the unpadded gradients on the valid rows and zeros
    below."""
    args = make_inputs(5, b=1, t=21)
    dy = torch.from_numpy(np.random.RandomState(6).normal(size=(1, 21, D)).astype(np.float32))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ref = torch.autograd.grad(fused_decoder_layer_train(*ins, H, mxu_dtype=torch.float32), ins, dy)
    padded = [F.pad(ins[0], (0, 0, 0, 43)), F.pad(ins[1], (0, 0, 0, 43))] + ins[2:]
    out = fused_decoder_layer_train(*padded, H, mxu_dtype=torch.float32, t_valid=21)
    got = torch.autograd.grad(out[:, :21], ins, dy)
    for name, a, g in zip(NAMES, ref, got):
        torch.testing.assert_close(g, a, atol=1e-5, rtol=1e-4, msg=name)


def test_pack_is_differentiable():
    """Gradients through the packed banks equal the module path's, for
    every parameter of the layer (the pack used to detach its weights)."""
    cfg = DenoiserConfig(num_frames=40, latent_dim=32, ff_size=16, num_layers=1, num_heads=4)
    model = MotionTransformer.from_config(cfg)
    load_reference_state_dict(model, synthetic_state_dict(model, seed=4))
    blk = model.temporal_decoder_blocks[0]
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.normal(size=(2, 11, 32)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(2, 11, 128)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, 4, 8, 8)).astype(np.float32) * 0.3)
    w = torch.from_numpy(rng.normal(size=(2, 11, 32)).astype(np.float32))
    params = list(blk.parameters())

    ref = torch.autograd.grad((blk(x, kv, emb, None) * w).sum(), params, allow_unused=True)
    out = decoder_layer_plain(x, F.silu(emb), expand_block_diag(kv), *pack_layer_weights(model, 0), 4)
    got = torch.autograd.grad((out * w).sum(), params, allow_unused=True)
    for (name, _), a, g in zip(blk.named_parameters(), ref, got):
        if a is None:  # the cross block's key / value path: not in a layer call
            assert g is None, name
            continue
        assert g is not None, name
        torch.testing.assert_close(g, a, atol=1e-5, rtol=1e-4, msg=name)
    # serving still packs without a graph
    with torch.no_grad():
        assert not pack_layer_weights(model, 0)[0].requires_grad
