"""PyTorch port: K7, the fused frozen ST-GCN (`ops/stgcn.py`), on the CPU.

Its plain version (forward, and d(motion) by autograd through it) against
the JAX `fused_frozen_stgcn` in interpret mode, on the same reference-format
weights (`synthetic_motion_encoder_state_dict`, imported into JAX by
`import_motion_encoder`): float32 at `tests/test_pallas_stgcn.py`'s bounds,
bf16 within 2 % of the largest value.

The JAX kernel pads T to a multiple of 8 and zeroes its pad rows only after
each block, so a pad row's graph-conv activation relu(b1) reaches the last
real frame through the temporal conv: on a ragged T it departs from its own
module wherever some b1 > 0 (0.36 of a maximum 1.98 here at T = 21).  The
reference zero-pads the conv at the clip's edge, and so does the port.  So
the JAX kernel is compared at T = 24 and 16, and the ragged T = 21 and 17
against the flax module.  Also: the float32 pack against the port's
module, the masks that ``save`` keeps, the plain backward from those masks
against the JAX kernel's `jax.grad` in bf16, the autograd Function's
gradients, the kernel wrappers' refusals, and the trainer's pack refresh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.interop.torch_import import import_motion_encoder
from conductor_tpu.models.graph import build_adjacency
from conductor_tpu.models.stgcn import MotionEncoderSTGCN as FlaxMotionEncoder
from conductor_tpu.ops.pallas_stgcn import fused_frozen_stgcn as jax_fused_frozen_stgcn
from conductor_tpu.ops.pallas_stgcn import pack_frozen_stgcn as jax_pack_frozen_stgcn
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu_torch.interop import (
    load_motion_encoder_state_dict,
    synthetic_motion_encoder_state_dict,
    synthetic_state_dict,
)
from conductor_tpu_torch.models.stgcn import MotionEncoderSTGCN
from conductor_tpu_torch.ops import launch_counts, reset_launch_counts
from conductor_tpu_torch.ops.stgcn import (
    PACK_KEYS,
    _check_kernel_args,
    frozen_stgcn_plain,
    fused_frozen_stgcn,
    pack_frozen_stgcn,
    stgcn_backward,
    stgcn_backward_plain,
    stgcn_forward,
    unpack_relu_masks,
)
from test_torch_port_stgcn_plan import _blocks

torch.set_num_threads(2)

B = 2
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def encoder():
    """The port's module and the JAX variables, on the same weights."""
    model = MotionEncoderSTGCN()
    sd = synthetic_motion_encoder_state_dict(model, seed=3)
    load_motion_encoder_state_dict(model, sd)
    variables = jax.tree.map(jnp.asarray, import_motion_encoder(sd))
    return model.freeze(), variables


def _inputs(t):
    rng = np.random.RandomState(t)
    motion = rng.uniform(0, 1, size=(B, t, 13, 2)).astype(np.float32)
    dy = rng.normal(size=(B, t, 64)).astype(np.float32)
    return motion, dy


def _jax_pack(variables, dtype):
    return jax_pack_frozen_stgcn(variables, build_adjacency("ConductorMotionX", "uniform"),
                                 mxu_dtype=DTYPES[dtype][1])


def _port(model, motion, dy, dtype):
    """The plain version's output and d(motion) of sum(out * dy)."""
    tdt = DTYPES[dtype][0]
    x = torch.from_numpy(motion).requires_grad_(True)
    out = frozen_stgcn_plain(x, pack_frozen_stgcn(model, tdt), tdt)
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(dy))
    assert out.shape == (B, motion.shape[1], 64) and grad.shape == motion.shape
    return out.detach().numpy(), grad.numpy()


def _assert_close(got, grad, want, want_grad, dtype, f32_grad=None):
    """float32: the JAX kernel test's bounds.  bf16: the forward within 2 %
    of the largest value; d(motion) within 2 % in norm, and nearer the JAX
    bf16 gradient than that is to the JAX float32 one (``f32_grad``).  In
    bf16 a ReLU mask flips where the two sum in another order, and a flip
    moves single elements of the gradient by several percent of its
    maximum: JAX's own bf16 gradient is 7-9 % (norm) off its float32 one."""
    scale = float(np.abs(want_grad).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(grad, want_grad, atol=3e-4 * max(scale, 1.0), rtol=2e-3)
    else:
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
        off = np.linalg.norm(grad - want_grad)
        assert off <= 0.02 * np.linalg.norm(want_grad)
        assert off <= 0.5 * np.linalg.norm(want_grad - f32_grad)


def _jax_kernel(variables, motion, dy, dtype):
    jdt = DTYPES[dtype][1]
    jpack = _jax_pack(variables, dtype)
    out = jax_fused_frozen_stgcn(jnp.asarray(motion), jpack, jdt)
    grad = jax.grad(lambda m: (jax_fused_frozen_stgcn(m, jpack, jdt) * jnp.asarray(dy)).sum())(
        jnp.asarray(motion))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("t", [24, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(encoder, dtype, t):
    model, variables = encoder
    motion, dy = _inputs(t)
    want, want_grad = _jax_kernel(variables, motion, dy, dtype)
    f32_grad = _jax_kernel(variables, motion, dy, "float32")[1] if dtype == "bfloat16" else None
    _assert_close(*_port(model, motion, dy, dtype), want, want_grad, dtype, f32_grad)


@pytest.mark.parametrize("t", [21, 17])
def test_ragged_clips_match_flax_module(encoder, t):
    """On a ragged T the float32 plain version and its d(motion) are the
    flax module's and `jax.grad`'s, at the JAX kernel test's bounds."""
    model, variables = encoder
    motion, dy = _inputs(t)
    flax_model = FlaxMotionEncoder()
    want = np.asarray(flax_model.apply(variables, jnp.asarray(motion)))
    want_grad = np.asarray(jax.grad(
        lambda m: (flax_model.apply(variables, m) * jnp.asarray(dy)).sum())(jnp.asarray(motion)))
    _assert_close(*_port(model, motion, dy, "float32"), want, want_grad, "float32")


@pytest.mark.parametrize("t", [21, 17])
def test_float32_pack_matches_module(encoder, t):
    """The folding (data_bn, adjacency x edge importance x GraphConv, every
    BN, the permuted projection) is exact up to float32 rounding."""
    model, _ = encoder
    motion = torch.from_numpy(_inputs(t)[0])
    with torch.no_grad():
        want = model(motion)
    got = frozen_stgcn_plain(motion, pack_frozen_stgcn(model, torch.float32), torch.float32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_saved_activations_are_the_blocks(encoder):
    """``save`` returns each block's ReLU masks in `stgcn_forward`'s bit
    layout: [g > 0] and [h > 0], (10, B*T, 13) int32 each, bit c of word v
    for channel c of joint v, those of the blocks' activations (written out
    apart in `test_torch_port_stgcn_plan._blocks`); the last h projects to
    the output."""
    model, _ = encoder
    motion = torch.from_numpy(_inputs(17)[0])
    pack = pack_frozen_stgcn(model, torch.bfloat16)
    out, (gmask, hmask) = frozen_stgcn_plain(motion, pack, torch.bfloat16, save=True)
    assert gmask.shape == hmask.shape == (10, B * 17, 13)
    assert gmask.dtype == hmask.dtype == torch.int32
    torch.testing.assert_close(out, frozen_stgcn_plain(motion, pack, torch.bfloat16), rtol=0,
                               atol=0)
    gs, hs = _blocks(motion, pack, torch.bfloat16)
    for i in range(10):
        assert torch.equal(unpack_relu_masks(gmask[i]), gs[i] > 0)
        assert torch.equal(unpack_relu_masks(hmask[i]), hs[i] > 0)
    assert bool(unpack_relu_masks(hmask[-1]).any())
    proj = hs[-1].to(torch.bfloat16).float() @ pack["fc"].float() + pack["fcb"]
    torch.testing.assert_close(proj.reshape(out.shape), out, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [24, 16])
def test_backward_plain_from_masks_matches_jax_kernel(encoder, t):
    """In bf16, `stgcn_backward_plain` on the plain forward's masks against
    `jax.grad` of the JAX kernel (its backward kernel, which recomputes the
    forward's masks), within `_assert_close`'s bf16 bounds."""
    model, variables = encoder
    motion, dy = _inputs(t)
    want, want_grad = _jax_kernel(variables, motion, dy, "bfloat16")
    f32_grad = _jax_kernel(variables, motion, dy, "float32")[1]
    pack = pack_frozen_stgcn(model, torch.bfloat16)
    out, masks = frozen_stgcn_plain(torch.from_numpy(motion), pack, torch.bfloat16, save=True)
    grad = stgcn_backward_plain(torch.from_numpy(dy), masks, pack, torch.bfloat16)
    _assert_close(out.numpy(), grad.numpy(), want, want_grad, "bfloat16", f32_grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_gives_no_pack_gradients(encoder, dtype):
    """On CPU tensors the autograd Function is the plain version, its
    d(motion) is autograd's through it, the pack takes no gradient, and no
    kernel launch is counted."""
    model, _ = encoder
    tdt = DTYPES[dtype][0]
    motion, dy = _inputs(17)
    pack = {k: v.clone().requires_grad_(v.is_floating_point())
            for k, v in pack_frozen_stgcn(model, tdt).items()}
    reset_launch_counts()
    x = torch.from_numpy(motion).requires_grad_(True)
    out = fused_frozen_stgcn(x, pack, tdt)
    (out * torch.from_numpy(dy)).sum().backward()
    assert launch_counts()["stgcn_forward"] == launch_counts()["stgcn_backward"] == 0
    assert all(pack[k].grad is None for k in PACK_KEYS)
    ref = torch.from_numpy(motion).requires_grad_(True)
    plain = frozen_stgcn_plain(ref, {k: v.detach() for k, v in pack.items()}, tdt)
    (plain * torch.from_numpy(dy)).sum().backward()
    torch.testing.assert_close(out.detach(), plain.detach(), rtol=0, atol=0)
    torch.testing.assert_close(x.grad, ref.grad, rtol=0, atol=0)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(encoder):
    """The kernels take bf16 or float32 operands in the pack's dtype, 13
    joints and tensors on the card; anything else raises ValueError before
    a launch."""
    model, _ = encoder
    motion = torch.from_numpy(_inputs(17)[0])
    pack = pack_frozen_stgcn(model, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        _check_kernel_args(motion, pack, torch.float32)
    with pytest.raises(ValueError, match="13 joints"):
        stgcn_forward(motion[:, :, :12], pack)
    with pytest.raises(ValueError, match="bfloat16"):  # a bf16 matrix in a float32 pack
        stgcn_forward(motion, dict(pack_frozen_stgcn(model, torch.float32), m0=pack["m0"]))
    with pytest.raises(ValueError, match="bf16 or float32"):
        stgcn_forward(motion, pack_frozen_stgcn(model, torch.float16))
    with pytest.raises(ValueError, match="CUDA"):  # the pack lies on the CPU
        stgcn_forward(motion, pack)
    saved = frozen_stgcn_plain(motion, pack, torch.bfloat16, save=True)[1]
    with pytest.raises(ValueError, match="CUDA"):
        stgcn_backward(torch.zeros(B, 17, 64), saved, pack)
    assert launch_counts()["stgcn_forward"] == launch_counts()["stgcn_backward"] == 0


def test_trainer_rebuilds_the_pack_on_new_weights():
    """The pack is built once outside the step and rebuilt when new ST-GCN
    weights load: after a reload the perceptual loss is that of a trainer
    that had the new weights from the start, and the plain module's on the
    same weights.  A stale pack would score against the old weights."""
    def make(feat_impl):
        cfg = Config(denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16,
                                             num_layers=2, num_heads=4),
                     diffusion=DiffusionConfig(steps=8, schedule="cosine"),
                     train=TrainConfig(feat_impl=feat_impl, cached_features=True))
        return DDPMTrainer(cfg, device="cpu")

    tr = make("pallas")
    assert tr.cfg.train.feat_impl == "pallas" and tr.feat_pack is not None
    sd = synthetic_state_dict(tr.model, seed=1)
    first = synthetic_motion_encoder_state_dict(tr.feat_model, seed=4)
    second = synthetic_motion_encoder_state_dict(tr.feat_model, seed=5)
    rng = np.random.RandomState(0)
    feats = rng.normal(size=(2, 32, 64)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(2, 32, 13, 2)).astype(np.float32)
    drawn = {"t": np.array([3, 5]), "noise": rng.normal(size=(2, 32, 26)).astype(np.float32),
             "cond_keep": np.ones((2, 32), np.float32)}

    def feat_loss(trainer, st_gcn):
        trainer.load_reference_state_dict(sd, motion_encoder=st_gcn)
        return float(trainer.train_step(feats, motion, **drawn)["loss_mot_feat"])

    feat_loss(tr, first)
    before = {k: v.clone() for k, v in tr.feat_pack.items()}
    reloaded = feat_loss(tr, second)
    want = pack_frozen_stgcn(tr.feat_model, torch.float32)
    assert all(torch.equal(tr.feat_pack[k], want[k]) for k in PACK_KEYS)
    assert not torch.equal(before["m"], tr.feat_pack["m"])
    assert reloaded == feat_loss(make("pallas"), second)
    np.testing.assert_allclose(reloaded, feat_loss(make("flax"), second), rtol=1e-4)
