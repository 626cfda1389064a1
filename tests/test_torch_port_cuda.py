"""PyTorch port on the card: every CUDA kernel against its plain version,
generate on the kernel path against the plain path, a training step
through K5 / K6 / K7 against the plain path, at a small size (2 decoder
layers, 3.2-s clips), the stage-1 kernels (K4's training modes, K9, K10,
K11 on tied inputs) and a B = 2 M2SNet step on them against the plain
path, K8 at its two paths' shapes, a reference-mask step and a
plain-layer generate through K8, K1's int8-AdaLN and bf16-VPU modes and
K2's int8 output at whole and ragged tiles, K2 (both modes) and K3 at a
ragged T and below one tile (one launch a call, repeating bit for bit,
the tiling `ops.sampler_glue.plan` computes), generate under bench.py's
serving config, the int8 wrappers raising on what their kernels do not
take, a float32 stage-1 step with torch's TF32 defaults against the
CPU (the entry points turn TF32 off), K1's AdaLN GEMM alone in bf16
and int8 at four row counts, 8 layers at once as K1 launches it, the
GEMM launches that K1, K5 and K6 report, K6 alone at B = 1 and 5, at a
ragged t_valid, repeating bit for bit, and K7 alone at ragged T, T inside
one tile and B = 1 (a repeat bit-identical, 10 launches a call, the
forward keeping only its ReLU bit masks), and an M2SGAN step on the
kernels ("auto": K4 on the frozen encoder and K7 in the SyncLoss; with
the encoder training, K4's training modes, K9, K10 and K11) against the
plain float32 step at S = 6, and 2 steps of the stage-2 training CLI
launching K5 / K6 / K7 every step.  Skips
without a CUDA card; on one, run it with
``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
``chip_smoke.py`` makes the same checks at the flagship size."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from conductor_tpu_torch import DDPMTrainer, M2SGANTrainer, M2SNetTrainer
from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu_torch.interop import (
    synthetic_discriminator_state_dict,
    synthetic_generator_state_dict,
    synthetic_m2snet_state_dict,
    synthetic_motion_encoder_state_dict,
    synthetic_state_dict,
)
from conductor_tpu_torch.kernel_checks import (
    REL_TOL,
    check_attention_kernel,
    check_conv_blocks,
    check_kernels,
    check_stage1_kernels,
    check_stgcn_kernels,
    check_train_kernels,
    gan_encoder_kernel_inputs,
    launch_split,
    perceptual_inputs,
    prologue_tie_errors,
    stage1_kernel_inputs,
    vpu_mode_errors,
    vpu_mode_ok,
)
from conductor_tpu_torch.ops import (
    conv3x3_dkernel,
    decoder_layer_bwd,
    decoder_layer_bwd_plain,
    linear_attention_kernel,
    fused_conv_block,
    fused_decoder_layer,
    fused_decoder_stack,
    fused_max_pool,
    launch_counts,
    max_pool_bwd,
    part_launch_counts,
    quantize_rows,
    reset_launch_counts,
    sampler_prologue,
)
from conductor_tpu_torch.ops.conv_block import conv_block_plain
from conductor_tpu_torch.ops.decoder_stack import (
    adaln_modulation,
    adaln_modulation_plain,
    decoder_stack_plain,
)
from conductor_tpu_torch.ops.sampler_glue import KERNEL_PLAN_KEYS as GLUE_PLAN_KEYS
from conductor_tpu_torch.ops.sampler_glue import kernel_plan as kernel_glue_plan
from conductor_tpu_torch.ops.sampler_glue import plan as glue_plan
from conductor_tpu_torch.ops.sampler_glue import (
    sampler_epilogue,
    sampler_epilogue_plain,
    sampler_prologue_plain,
)
from conductor_tpu_torch.ops.conv_train import conv3x3_dkernel_plain
from conductor_tpu_torch.ops import attention
from conductor_tpu_torch.ops.attention import fold_key_mask, linear_attention_plain
from conductor_tpu_torch.ops.max_pool import (
    KERNEL_FWD_PLAN_KEYS,
    fwd_plan,
    kernel_fwd_plan,
    max_pool_bwd_plain,
    max_pool_plain,
)
from conductor_tpu_torch.models.stgcn import MotionEncoderSTGCN
from conductor_tpu_torch.interop import load_motion_encoder_state_dict
from conductor_tpu_torch.ops.stgcn import (
    KERNEL_PLAN_KEYS,
    frozen_stgcn_plain,
    kernel_plan,
    pack_frozen_stgcn,
    plan,
    stgcn_backward,
    stgcn_backward_plain,
    stgcn_forward,
    unpack_relu_masks,
)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def trainers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = Config(denoiser=DenoiserConfig(num_frames=96, num_layers=2),
                 diffusion=DiffusionConfig(steps=20, schedule="cosine"))
    kernel = DDPMTrainer(cfg, device="cuda")
    plain = DDPMTrainer(cfg.replace(denoiser=DenoiserConfig(
        num_frames=96, num_layers=2, layer_impl="flax", music_encoder_impl="flax",
        train_layer_impl="flax", attention_impl="xla", compute_dtype="float32"),
        train=TrainConfig(feat_impl="flax")), device="cuda")
    assert kernel.cfg.train.feat_impl == "pallas"
    sd = synthetic_state_dict(kernel.model, seed=0)
    feat_sd = synthetic_motion_encoder_state_dict(kernel.feat_model, seed=0)
    kernel.load_reference_state_dict(sd, motion_encoder=feat_sd)
    plain.load_reference_state_dict(sd, motion_encoder=feat_sd)
    rng = np.random.RandomState(0)
    # T = 96 motion frames: one full 64-row tile and one ragged one
    mel = torch.from_numpy(rng.uniform(0, 1, size=(2, 288, 128)).astype(np.float32)).cuda()
    noise = torch.from_numpy(rng.normal(size=(2, 96, 26)).astype(np.float32)).cuda()
    yield kernel, plain, mel, noise
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _stage1_trainers(**kw):
    kernel = M2SNetTrainer(sample_length=6, clip_length=2, device="cuda", **kw)
    plain = M2SNetTrainer(sample_length=6, clip_length=2, compute_dtype="float32",
                          music_conv_impl="lax", device="cuda", **kw)
    sd = synthetic_m2snet_state_dict(kernel.model, seed=0)
    kernel.load_reference_state_dict(sd)
    plain.load_reference_state_dict(sd)
    rng = np.random.RandomState(0)
    music = torch.from_numpy(rng.uniform(0, 1, size=(2, 540, 128)).astype(np.float32)).cuda()
    motion = torch.from_numpy(rng.uniform(0, 1, size=(2, 180, 13, 2)).astype(np.float32)).cuda()
    return kernel, plain, music, motion


def test_kernels_match_plain_versions(trainers):
    kernel, _, mel, noise = trainers
    motion = torch.rand(2, 96, 13, 2, device="cuda")
    s1, _, music, motion_s1 = _stage1_trainers()
    results = check_kernels(kernel, mel, noise, reps=1) + check_train_kernels(
        kernel, mel, motion, reps=1) + check_stgcn_kernels(
        kernel.feat_model, kernel.feat_pack, getattr(torch, kernel.cfg.denoiser.compute_dtype),
        *perceptual_inputs(kernel, mel, motion), reps=1) + check_stage1_kernels(
        *stage1_kernel_inputs(s1, music, motion_s1, (0, 120)), reps=1)
    q, k, v = (torch.randn(2, 96, 128, device="cuda").to(torch.bfloat16) for _ in range(3))
    results.append(check_attention_kernel(q, k, v, torch.ones(2, 96, 1, device="cuda"), 8, reps=1))
    assert {r["name"] for r in results} - {"conv_block_train"} == set(launch_counts()) | {
        "adaln_modulation", "adaln_modulation_int8"}
    for r in results:
        assert r["ok"], r
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations"), r


def _rand(*shape, gen):
    return torch.randn(shape, generator=gen, device="cuda")


def _check_conv_block(x, cout, *, gen, res_mode=0, affine=True, **kw):
    """K4 on ``x`` with seeded weights against its plain version: within
    2 % of the plain output's largest value (REL_TOL), and a repeat
    bit-identical.  Returns the plain output (float32)."""
    cin = x.shape[-1]
    args = dict(kernel=_rand(3, 3, cin, cout, gen=gen) * 0.2,
                scale=_rand(cout, gen=gen) * 0.2 + 1 if affine else torch.ones(cout, device="cuda"),
                bias=_rand(cout, gen=gen) * 0.1 if affine else torch.zeros(cout, device="cuda"))
    if res_mode == 2:
        args.update(res_kernel=_rand(cin, cout, gen=gen) * 0.2,
                    res_scale=_rand(cout, gen=gen) * 0.2 + 1, res_bias=_rand(cout, gen=gen) * 0.1)
    got = fused_conv_block(x, res_mode=res_mode, **args, **kw)
    want = conv_block_plain(x, res_mode=res_mode, **args, **kw)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= 0.02 * float(want.float().abs().max())
    assert torch.equal(got, fused_conv_block(x, res_mode=res_mode, **args, **kw))
    return want.float()


@pytest.mark.parametrize("edge", ["reflect", "zero"])
@pytest.mark.parametrize("cin,cout,f", [(1, 16, 128), (16, 32, 64), (32, 16, 64), (32, 32, 32)])
def test_conv_block_training_modes(cin, cout, f, edge):
    """K4 with relu off, identity affine and no residual, reflect or zero
    edge: the trainable conv's forward and the interior of its transposed
    conv; a repeat bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(cin + cout)
    x = _rand(2, 30, f, cin, gen=gen).to(torch.bfloat16)
    want = _check_conv_block(x, cout, gen=gen, affine=False, relu=False, edge=edge)
    assert float(want.min()) < 0  # the ReLU is off


POOLS = [((5, 5), (1, 2), ((2, 2), (2, 2))), ((5, 5), (3, 2), ((2, 2), (2, 2))),
         ((3, 3), (1, 2), ((1, 1), (1, 1)))]


@pytest.mark.parametrize("cin,cout,f,t,b,res_mode,pool,relu,edge", [
    # each residual mode without a pool and with each of the encoder's three
    # pools, at T = 31 / 37 (a multiple of no tile's rows, nor of the pool's
    # time stride 3), B = 1 and 2
    (1, 16, 128, 37, 1, 0, None, True, "reflect"),
    (16, 16, 128, 31, 2, 0, POOLS[0], True, "reflect"),
    (32, 32, 64, 37, 1, 0, POOLS[1], True, "reflect"),
    (32, 32, 32, 31, 2, 0, POOLS[2], True, "reflect"),
    (16, 16, 128, 37, 2, 1, None, True, "reflect"),
    (16, 16, 128, 37, 1, 1, POOLS[0], True, "reflect"),
    (32, 32, 64, 31, 2, 1, POOLS[1], True, "reflect"),
    (32, 32, 32, 37, 1, 1, POOLS[2], True, "reflect"),
    (16, 32, 64, 31, 2, 2, None, True, "reflect"),
    (16, 32, 128, 37, 1, 2, POOLS[0], True, "reflect"),
    (16, 32, 64, 37, 2, 2, POOLS[1], True, "reflect"),
    (32, 16, 32, 31, 1, 2, POOLS[2], True, "reflect"),
    # Cin = 1 with a pool and a 1x1 residual (its weight at the centre tap)
    (1, 16, 128, 31, 1, 0, POOLS[0], True, "reflect"),
    (1, 32, 64, 37, 2, 2, POOLS[1], True, "reflect"),
    # T = 2, F = 8: every row an edge row, pool windows past both ends
    (16, 16, 8, 2, 3, 1, None, True, "reflect"),
    (16, 16, 8, 2, 2, 1, POOLS[0], True, "reflect"),
    (32, 32, 8, 2, 1, 2, POOLS[1], True, "reflect"),
    # the training modes at ragged T and B = 1, both edges
    (1, 16, 128, 37, 1, 0, None, False, "zero"),
    (32, 16, 64, 31, 1, 0, None, False, "reflect"),
    (32, 32, 32, 37, 2, 0, None, False, "zero"),
    (16, 16, 8, 2, 3, 0, None, False, "zero"),
])
def test_conv_block_modes_and_shapes(cin, cout, f, t, b, res_mode, pool, relu, edge):
    """K4 in every residual mode, with and without each pool, and in the
    training modes, at ragged shapes, against its plain version; a repeat
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(cin * cout + f + t)
    x = _rand(b, t, f, cin, gen=gen).to(torch.bfloat16)
    _check_conv_block(x, cout, gen=gen, res_mode=res_mode, pool=pool, relu=relu, edge=edge,
                      affine=relu)


def test_conv_block_pooled_call_allocates_no_conv_output():
    """A pooled block's call allocates its pooled output and nothing of the
    full-resolution conv output's size: its peak over the memory before it
    stays under the conv output's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = _rand(2, 900, 128, 16, gen=gen).to(torch.bfloat16)
    args = (x, _rand(3, 3, 16, 16, gen=gen) * 0.2, torch.ones(16, device="cuda"),
            torch.zeros(16, device="cuda"))
    fused_conv_block(*args, res_mode=1, pool=POOLS[0])  # build and warm up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fused_conv_block(*args, res_mode=1, pool=POOLS[0])
    torch.cuda.synchronize()
    assert out.shape == (2, 900, 64, 16)
    peak = torch.cuda.max_memory_allocated() - before
    assert out.numel() * 2 <= peak < x.numel() * 2, (peak, x.numel() * 2)


@pytest.mark.parametrize("cin,cout,f,t,b", [
    (1, 16, 128, 30, 3), (16, 16, 128, 30, 3), (16, 32, 64, 30, 3), (32, 32, 32, 10, 3),
    (16, 16, 8, 2, 3),
    # the five (F, Cin, Cout) of the stage-1 encoder's seven convs, at a T
    # that is a multiple of no tile's rows
    (1, 16, 128, 37, 2), (16, 16, 128, 37, 2), (16, 32, 64, 37, 2), (32, 32, 64, 37, 2),
    (32, 32, 32, 37, 2),
    # F not a multiple of 16
    (32, 16, 18, 37, 2), (1, 32, 18, 11, 2),
])
def test_conv3x3_dkernel_matches_plain(cin, cout, f, t, b):
    """K9 against the d(kernel) sum written out, bf16 operands on both sides;
    the products are exact in float32, so only the order of the sums differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(cin * cout + f)
    x = _rand(b, t, f, cin, gen=gen).to(torch.bfloat16)
    dy = _rand(b, t, f, cout, gen=gen).to(torch.bfloat16)
    got, want = conv3x3_dkernel(x, dy), conv3x3_dkernel_plain(x, dy)
    assert got.shape == (3, 3, cin, cout)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert torch.equal(got, conv3x3_dkernel(x, dy))  # deterministic


@pytest.mark.parametrize("pool,c,f,t,b", [
    (POOLS[0], 16, 128, 36, 2), (POOLS[1], 32, 64, 36, 2), (POOLS[2], 32, 32, 12, 2),
    # K11's tiling: T a multiple of no tile's rows, T inside one tile, B = 1,
    # the smallest F a pool takes, and rows too wide for one block (column
    # chunks with their halo)
    (POOLS[0], 16, 128, 31, 1), (POOLS[0], 16, 128, 97, 2), (POOLS[0], 16, 1, 37, 1),
    (POOLS[0], 16, 200, 37, 1), (POOLS[0], 16, 128, 2, 3),
    (POOLS[1], 32, 64, 33, 1), (POOLS[1], 32, 64, 99, 2), (POOLS[1], 32, 1, 33, 1),
    (POOLS[1], 32, 70, 99, 1), (POOLS[1], 32, 64, 2, 3),
    (POOLS[2], 32, 32, 31, 1), (POOLS[2], 32, 32, 97, 2), (POOLS[2], 32, 1, 37, 1),
    (POOLS[2], 32, 70, 37, 1), (POOLS[2], 32, 32, 2, 3),
    # the stage-1 stride-3 pool at C = 16, the stride-1 5x5 one at C = 32
    (POOLS[1], 16, 128, 37, 1), (POOLS[0], 32, 64, 31, 1),
])
def test_max_pool_kernels(pool, c, f, t, b):
    """K10 exact against the plain pool; K11 exact against the plain
    first-max routing on tied inputs (post-ReLU plateaus rounded to a
    coarse grid, a cotangent whose sums are exact in any order), and
    conservative (sum dx == sum dy); on random inputs within REL_TOL of the
    plain version's largest value, a repeat bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(c + t + f)
    x = _rand(b, t, f, c, gen=gen).to(torch.bfloat16)
    assert torch.equal(fused_max_pool(x, pool), max_pool_plain(x, pool))
    tied = (torch.relu(x.float()) * 2).round().div(2).to(torch.bfloat16)
    y = fused_max_pool(tied, pool)
    dy = (torch.randint(-8, 9, y.shape, generator=gen, device="cuda") / 4).to(torch.bfloat16)
    got = max_pool_bwd(tied, dy, pool)
    assert torch.equal(got, max_pool_bwd_plain(tied, dy, pool))
    assert float(got.float().sum()) == float(dy.float().sum())
    dy = _rand(*y.shape, gen=gen).to(torch.bfloat16)
    got, want = max_pool_bwd(x, dy, pool), max_pool_bwd_plain(x, dy, pool)
    assert float((got.float() - want.float()).abs().max()) <= 0.02 * float(want.float().abs().max())
    assert torch.equal(got, max_pool_bwd(x, dy, pool))


def test_max_pool_bwd_allocates_only_dx():
    """A K11 call allocates its output dx and no scratch of dy's shape (the
    int32 winner array of the two-pass design): its peak over the memory
    before it stays under dx's bytes plus an int32 array of dy's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = _rand(2, 900, 128, 16, gen=gen).to(torch.bfloat16)
    dy = _rand(2, 900, 64, 16, gen=gen).to(torch.bfloat16)
    max_pool_bwd(x, dy, POOLS[0])  # build and warm up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dx = max_pool_bwd(x, dy, POOLS[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert dx.numel() * 2 <= peak < dx.numel() * 2 + dy.numel() * 4, (peak, dx.numel() * 2)


def test_max_pool_bwd_raises_on_other_geometries():
    """K11 takes the encoder's three pools at C = 16 or 32 and raises on
    any other channels or window (its kernel's template instances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for c, pool in ((8, POOLS[0]), (64, POOLS[0]), (16, ((3, 3), (2, 2), ((1, 1), (1, 1))))):
        x = torch.zeros(1, 12, 16, c, device="cuda", dtype=torch.bfloat16)
        dy = torch.zeros_like(max_pool_plain(x, pool))
        with pytest.raises(ValueError, match="pools"):
            max_pool_bwd(x, dy, pool)


def test_max_pool_fwd_raises_on_other_geometries():
    """K10 takes the encoder's three pools at C = 16 or 32 (its kernel's
    template instances, K11's) and raises on any other channels or window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for c, pool in ((8, POOLS[0]), (64, POOLS[0]), (16, ((3, 3), (2, 2), ((1, 1), (1, 1))))):
        x = torch.zeros(1, 12, 16, c, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="pools"):
            fused_max_pool(x, pool)


@pytest.mark.parametrize("pool,shape", [(POOLS[0], (2, 900, 128, 16)), (POOLS[1], (2, 900, 64, 32)),
                                        (POOLS[2], (2, 300, 32, 32)), (POOLS[1], (1, 99, 70, 32))])
def test_max_pool_fwd_one_launch_on_the_plan(pool, shape):
    """K10 at the stage-1 pools' widths (and rows too wide for one block):
    one launch a call, a repeat bit-identical, exact, and the tiling the
    kernel runs (`max_pool_fwd_plan`) the one `fwd_plan` computes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(shape[1])
    x = _rand(*shape, gen=gen).to(torch.bfloat16)
    call = lambda: fused_max_pool(x, pool)  # noqa: E731
    assert torch.equal(call(), max_pool_plain(x, pool)) and torch.equal(call(), call())
    assert len(launch_split(call, 2)) == 1
    mine = fwd_plan(shape, pool)
    assert {k: mine[k] for k in KERNEL_FWD_PLAN_KEYS} == kernel_fwd_plan(
        shape, pool, mine["rows"], mine["cols"], mine["threads"])


@pytest.mark.parametrize("share_encodes", [False, True])
def test_m2snet_step_kernel_path_matches_plain_path(share_encodes, monkeypatch):
    """Two B = 2 stage-1 steps on the kernels (bf16) against the plain
    float32 path from the same weights and starts: the loss within the
    bf16 bound of tests/test_fused_train_path.py (3e-2 relative), every
    stage-1 kernel launched in each step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kernel, plain, music, motion = _stage1_trainers(share_encodes=share_encodes)
    for starts in ((0, 120), (10, 150)):
        reset_launch_counts()
        mk = kernel.train_step(music, motion, "hard", starts=starts)
        torch.cuda.synchronize()
        counts = launch_counts()
        for name in ("conv_block", "conv3x3_dkernel", "max_pool", "max_pool_bwd"):
            assert counts[name] > 0, counts
        mp = plain.train_step(music, motion, "hard", starts=starts)
        assert bool(torch.isfinite(mk["loss"]))
        assert abs(float(mk["loss"]) - float(mp["loss"])) <= 3e-2 * abs(float(mp["loss"]))


def test_generate_kernel_path_matches_plain_path(trainers):
    kernel, plain, mel, noise = trainers
    reset_launch_counts()
    out = kernel.generate(mel, num_steps=5, noise=noise)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == {"decoder_stack": 5, "decoder_stack_int8": 0, "decoder_stack_vpu_bf16": 0,
                      "sampler_prologue": 5, "sampler_prologue_int8": 0, "sampler_epilogue": 5,
                      "conv_block": 7, "decoder_layer": 0, "decoder_layer_bwd": 0,
                      "stgcn_forward": 0, "stgcn_backward": 0, "conv3x3_dkernel": 0,
                      "max_pool": 0, "max_pool_bwd": 0, "linear_attention": 0}
    ref = plain.generate(mel, num_steps=5, noise=noise)
    assert out.shape == (2, 96, 26) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 0.03 * float(ref.abs().max())


@pytest.mark.parametrize("vpu", ["float32", "bfloat16"])
def test_generate_bench_config_matches_plain_path(trainers, vpu):
    """bench.py's serving config (int8 AdaLN; with the bf16-VPU mode as a
    second case) on the card: ddim5 within 3 % of the plain float32 path,
    K2 and K1 in their int8 modes (and K1 in the bf16-VPU mode) on every
    step."""
    kernel, plain, mel, noise = trainers
    cfg = kernel.cfg.replace(denoiser=dataclasses.replace(
        kernel.cfg.denoiser, sampler_adaln_int8=True, sampler_vpu_dtype=vpu))
    bench = DDPMTrainer(cfg, device="cuda")
    bench.load_reference_state_dict(kernel.model.state_dict())
    reset_launch_counts()
    out = bench.generate(mel, num_steps=5, noise=noise)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["decoder_stack_int8"] == counts["sampler_prologue_int8"] == 5, counts
    assert counts["decoder_stack_vpu_bf16"] == (5 if vpu == "bfloat16" else 0), counts
    assert counts["decoder_stack"] == counts["sampler_prologue"] == 0, counts
    ref = plain.generate(mel, num_steps=5, noise=noise)
    assert out.shape == (2, 96, 26) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 0.03 * float(ref.abs().max())


def _stack_operands(t, gen, int8):
    """K1's operands at the flagship widths (D = 128, 8 heads, E = 512), two
    layers, B = 2; emb and adaln_w int8 with their scales, or bf16."""
    seg = (torch.arange(128, device="cuda")[:, None] // 16
           == torch.arange(128, device="cuda")[None, :] // 16).float()
    vecs = _rand(2, 24, 128, gen=gen) * 0.3
    vecs[:, [0, 5, 8, 11, 16]] += 1.0
    x, emb = _rand(2, t, 128, gen=gen), _rand(2, t, 512, gen=gen)
    aw = _rand(2, 512, 768, gen=gen) * 0.05
    args = [x, emb, (_rand(2, 2, 128, 128, gen=gen) * 0.3 * seg).to(torch.bfloat16),
            (_rand(2, 9, 128, 128, gen=gen) * 0.1).to(torch.bfloat16), vecs, aw,
            _rand(2, 768, gen=gen) * 0.1]
    kw = {}
    if int8:
        args[1], emb_scale = quantize_rows(emb)
        q, s = quantize_rows(aw.transpose(1, 2))
        args[5] = q.transpose(1, 2).contiguous()
        kw = dict(emb_scale=emb_scale, adaln_w_scale=s.transpose(1, 2).contiguous())
    else:
        args[1], args[5] = emb.to(torch.bfloat16), aw.to(torch.bfloat16)
    return args, kw


@pytest.mark.parametrize("t", [128, 100])
@pytest.mark.parametrize("int8,vpu", [(True, False), (False, True), (True, True)])
def test_decoder_stack_modes_match_plain(t, int8, vpu, monkeypatch):
    """K1 in the int8-AdaLN mode, the bf16-VPU mode and both, at whole
    (T = 128) and ragged (T = 100) tiles: within 2 % of the plain version's
    largest value; each mode counted where it launches.  In the bf16-VPU
    mode also `vpu_mode_ok`: the kernel moves with the mode, and its mean
    distance from the plain version is at most half the mode's mean move.
    These operands (outputs up to ~17) put many bf16 roundings within a
    float32 product's error of a tie, so that distance measured 0.25-0.31
    of the move on an H100, against 0.04 at the serving shape, where
    chip_smoke.py holds it to a quarter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # exact int8 plain
    gen = torch.Generator(device="cuda").manual_seed(t + 2 * int8 + vpu)
    args, kw = _stack_operands(t, gen, int8)
    kw.update(mxu_dtype=torch.bfloat16, vpu_dtype=torch.bfloat16 if vpu else torch.float32)
    reset_launch_counts()
    got = fused_decoder_stack(*args, 8, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["decoder_stack_int8"], counts["decoder_stack_vpu_bf16"],
            counts["decoder_stack"]) == (int(int8), int(vpu), 0), counts
    want = decoder_stack_plain(*args, 8, **kw)
    scale, err = float(want.abs().max()), float((got - want).abs().max())
    assert scale > 1.0
    assert err <= 0.02 * scale
    if vpu:
        kw.pop("vpu_dtype")
        r = vpu_mode_errors((*args, 8), **kw)
        assert vpu_mode_ok(r, 0.5), r


def test_k1_and_k5_count_the_gemm_launches_they_make():
    """K1 (8 layers) and K5 (one layer) each launch their AdaLN GEMM once a
    call, and the count is the one their C entry points report."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    args, _ = _stack_operands(128, gen, False)
    reset_launch_counts()
    fused_decoder_stack(*args, 8, mxu_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert part_launch_counts()["adaln_modulation"] == 1
    x, emb, kv, mats, vecs, aw, ab = args
    fused_decoder_layer(x.to(torch.bfloat16), emb, kv[0], mats[0], vecs[0], aw[0], ab[0], 8,
                        mxu_dtype=torch.bfloat16, t_valid=100)
    torch.cuda.synchronize()
    assert part_launch_counts()["adaln_modulation"] == 2
    assert launch_counts()["decoder_layer"] == launch_counts()["decoder_stack"] == 1


def _layer_operands(b, t, t_valid, gen):
    """K6's operands for one layer at the flagship widths (D = 128, 8 heads,
    E = 512): bf16 x, emb and block-diagonal kv_cross, the weight banks, and
    a cotangent zero past ``t_valid``."""
    seg = (torch.arange(128, device="cuda")[:, None] // 16
           == torch.arange(128, device="cuda")[None, :] // 16).float()
    vecs = _rand(24, 128, gen=gen) * 0.3
    vecs[[0, 5, 8, 11, 16]] += 1.0
    bf = torch.bfloat16
    args = (_rand(b, t, 128, gen=gen).to(bf), _rand(b, t, 512, gen=gen).to(bf),
            (_rand(b, 128, 128, gen=gen) * 0.3 * seg).to(bf), _rand(9, 128, 128, gen=gen) * 0.1,
            vecs, _rand(512, 768, gen=gen) * 0.05, _rand(768, gen=gen) * 0.1)
    dy = _rand(b, t, 128, gen=gen) * 0.1
    dy[:, t_valid:] = 0
    return args, dy.to(bf)


@pytest.mark.parametrize("b,t,t_valid", [(1, 128, 100), (5, 128, 100), (5, 192, 192)])
def test_layer_bwd_matches_plain(b, t, t_valid):
    """K6 at B = 1 and 5, at a ragged t_valid (100 of 128 rows) and at whole
    tiles: each of its seven gradients within 2 % of the plain version's
    largest value of that gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(b * t + t_valid)
    args, dy = _layer_operands(b, t, t_valid, gen)
    kw = dict(mxu_dtype=torch.bfloat16, t_valid=t_valid)
    got = decoder_layer_bwd(*args, dy, 8, **kw)
    want = decoder_layer_bwd_plain(*args, dy, 8, **kw)
    for name, g, w in zip(("dx", "demb", "dkvc", "dmats", "dvecs", "daw", "dab"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = float(w.float().abs().max())
        assert scale > 0 and float((g.float() - w.float()).abs().max()) <= 0.02 * scale, name


def test_layer_bwd_repeats_bit_for_bit_and_counts_its_gemm():
    """Two K6 calls on the same inputs give bit-identical gradients (every
    sum runs in a fixed order); each call counts one launch of K6 and one
    of the AdaLN GEMM it launches, as its C entry point reports it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(11)
    args, dy = _layer_operands(4, 960, 900, gen)
    reset_launch_counts()
    first = decoder_layer_bwd(*args, dy, 8, mxu_dtype=torch.bfloat16, t_valid=900)
    torch.cuda.synchronize()
    assert part_launch_counts()["adaln_modulation"] == 1
    assert launch_counts()["decoder_layer_bwd"] == 1
    again = decoder_layer_bwd(*args, dy, 8, mxu_dtype=torch.bfloat16, t_valid=900)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert part_launch_counts()["adaln_modulation"] == 2


@pytest.mark.parametrize("m", [100, 1800, 3600, 14400])
@pytest.mark.parametrize("int8", [False, True])
def test_adaln_modulation_matches_plain(m, int8, monkeypatch):
    """K1's AdaLN GEMM alone as K1 launches it, 8 layers at once, at B T =
    100 (one ragged tile), 1800 (one clip), 3600 and 14400 (B = 2 and 8
    clips), E = 512, 6D = 768: within 2 % of the plain version's largest
    value (in int8 the integer product is exact, so only the
    dequantization's rounding could differ), a repeat bit-identical, one
    launch a call as the C entry point reports it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # exact int8 plain
    gen = torch.Generator(device="cuda").manual_seed(m + int(int8))
    layers = 8
    emb = _rand(m, 512, gen=gen)
    w, bias = _rand(layers, 512, 768, gen=gen) * 0.05, _rand(layers, 768, gen=gen)
    if int8:
        emb, emb_scale = quantize_rows(emb)
        q, s = quantize_rows(w.transpose(1, 2))
        w, kw = q.transpose(1, 2).contiguous(), dict(
            emb_scale=emb_scale, adaln_w_scale=s.transpose(1, 2).contiguous())
    else:
        emb, w, kw = emb.to(torch.bfloat16), w.to(torch.bfloat16), dict(mxu_dtype=torch.bfloat16)
    reset_launch_counts()
    got = adaln_modulation(emb, w, bias, **kw)
    torch.cuda.synchronize()
    assert part_launch_counts()["adaln_modulation"] == 1
    want = adaln_modulation_plain(emb, w, bias, **kw)
    assert got.shape == (m, layers * 768) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())
    assert torch.equal(got, adaln_modulation(emb, w, bias, **kw))


@pytest.mark.parametrize("t", [128, 100])
def test_sampler_prologue_int8_matches_plain(t):
    """K2 with int8 output: h within 2 % of the plain version's largest
    value, the codes at most 1 apart at no more than 0.1 % of entries, the
    scales within 1e-6 relative, one count where it launches; on exact
    ties, every code rounded half to even."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(t)
    args = (_rand(2, t, 26, gen=gen), _rand(512, gen=gen), _rand(2, t, 512, gen=gen) * 2,
            _rand(26, 128, gen=gen) * 0.2, _rand(t + 10, 128, gen=gen))
    kw = dict(mxu_dtype=torch.bfloat16, quantize_emb=True)
    reset_launch_counts()
    h, q, s = sampler_prologue(*args, **kw)
    torch.cuda.synchronize()
    assert (launch_counts()["sampler_prologue_int8"], launch_counts()["sampler_prologue"]) == (1, 0)
    hp, qp, sp = sampler_prologue_plain(*args, **kw)
    assert q.dtype == torch.int8 and s.shape == (2, t, 1)
    assert float((h - hp).abs().max()) <= 0.02 * float(hp.abs().max())
    diff = (q.int() - qp.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    assert float(((s - sp).abs() / sp).max()) <= 1e-6
    assert prologue_tie_errors(args, mxu_dtype=torch.bfloat16) == 0


@pytest.mark.parametrize("mxu", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,t", [(2, 37), (1, 5)])
@pytest.mark.parametrize("kind", ["prologue", "prologue_int8", "epilogue"])
def test_sampler_glue_matches_plain_repeats_and_runs_its_plan(kind, b, t, mxu):
    """K2 (bf16 and int8 emb_act) and K3 at a ragged T (37) and at B T
    below one tile (B = 1, T = 5: fewer rows than a K3 tile or a K2
    block's warps), bf16 and float32 operands: within 2 % of the plain
    version's largest value (the int8 codes at most 1 apart at no more
    than 0.1 % of them), a repeat bit-identical, one launch a call (its
    count and the profiler's), and the tiling `plan` computes the
    kernel's `sampler_plan`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(b * 100 + t)
    md = getattr(torch, mxu)
    x, h = _rand(b, t, 26, gen=gen), _rand(b, t, 128, gen=gen)
    pro = (x, _rand(512, gen=gen), _rand(b, t, 512, gen=gen) * 2, _rand(26, 128, gen=gen) * 0.2,
           _rand(t + 3, 128, gen=gen))
    epi = (h, x, _rand(128, 26, gen=gen) * 0.1, _rand(26, gen=gen), 0.9, 0.1)
    if kind == "epilogue":
        call = functools.partial(sampler_epilogue, *epi, mxu_dtype=md)
        want, count = sampler_epilogue_plain(*epi, mxu_dtype=md), "sampler_epilogue"
    else:
        kw = dict(mxu_dtype=md, quantize_emb=True) if kind == "prologue_int8" else dict(
            mxu_dtype=md, emb_dtype=torch.bfloat16)
        call = functools.partial(sampler_prologue, *pro, **kw)
        want, count = sampler_prologue_plain(*pro, **kw), "sampler_" + kind
    reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    assert launch_counts()[count] == 1
    assert len(launch_split(call)) == 1
    if kind == "prologue_int8":
        diff = (got[1].int() - want[1].int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
        got, want = (got[0], got[1].float() * got[2]), (want[0], want[1].float() * want[2])
    pairs = zip(got, want) if kind != "epilogue" else [(got, want)]
    for g, w in pairs:
        if w is not None:
            err = float((g.float() - w.float()).abs().max())
            assert err <= REL_TOL * float(w.float().abs().max())
    first, again = call(), call()
    if kind == "epilogue":
        first, again = (first,), (again,)
    assert all(torch.equal(u, v) for u, v in zip(first, again) if u is not None)
    which = "epilogue" if kind == "epilogue" else "prologue"
    want_plan = glue_plan(b, t, which,
                          sms=torch.cuda.get_device_properties(0).multi_processor_count)
    assert kernel_glue_plan(b, t, which) == {k: want_plan[k] for k in GLUE_PLAN_KEYS}


def test_int8_kernels_raise_on_what_they_do_not_take():
    """On CUDA the int8 wrappers raise, and never fall back, on a dtype or
    shape their kernels do not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    args, kw = _stack_operands(64, gen, True)
    bf = torch.bfloat16
    bad = [
        (dict(mxu_dtype=torch.float32), {}),                        # float32 operands
        (dict(mxu_dtype=bf), {5: args[5].to(bf)}),                    # bf16 weights, int8 emb
        (dict(mxu_dtype=bf, emb_scale=kw["emb_scale"][:, :32]), {}),  # scales of another T
        (dict(mxu_dtype=bf, adaln_w_scale=kw["adaln_w_scale"].double()), {}),
        (dict(mxu_dtype=bf, emb_scale=None), {}),                    # one scale of two
    ]
    for over, swap in bad:
        a = [swap.get(i, v) for i, v in enumerate(args)]
        with pytest.raises(ValueError):
            fused_decoder_stack(*a, 8, **{**kw, **over})
    pro = (_rand(2, 64, 26, gen=gen), _rand(512, gen=gen), _rand(2, 64, 512, gen=gen).half(),
           _rand(26, 128, gen=gen), _rand(64, 128, gen=gen))
    with pytest.raises(ValueError):
        sampler_prologue(*pro, mxu_dtype=bf, quantize_emb=True)  # float16 emb_base


def test_train_step_kernel_path_matches_plain_path(trainers):
    """Two steps through K5 / K6 / K7 (T = 96, one ragged tile) against the
    plain float32 path on the same weights and random numbers: the loss and
    the perceptual term ``loss_mot_feat`` (weighted 1e-6 in the loss) within
    the bf16 bound of tests/test_fused_train_path.py (3e-2 relative)."""
    kernel, plain, mel, _ = trainers
    rng = np.random.RandomState(1)
    motion = torch.from_numpy(rng.uniform(0, 1, size=(2, 96, 13, 2)).astype(np.float32)).cuda()
    for step in range(2):
        drawn = {"t": rng.randint(0, 20, size=2), "noise": rng.normal(size=(2, 96, 26)),
                 "cond_keep": (rng.uniform(size=(2, 96)) > 0.1).astype(np.float32)}
        reset_launch_counts()
        mk = kernel.train_step(mel, motion, **drawn)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["decoder_layer"] == 2 and counts["decoder_layer_bwd"] == 2
        assert counts["stgcn_forward"] == 2 and counts["stgcn_backward"] == 1  # pred and target
        mp = plain.train_step(mel, motion, **drawn)
        assert bool(torch.isfinite(mk["loss"])) and bool(torch.isfinite(mk["grad_norm"]))
        for k in ("loss", "loss_mot_feat"):
            assert abs(float(mk[k]) - float(mp[k])) <= 3e-2 * abs(float(mp[k])), (step, k, mk, mp)


def _stgcn_pack():
    """K7's bf16 pack of the synthetic ST-GCN of seed 0, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = MotionEncoderSTGCN()
    load_motion_encoder_state_dict(model, synthetic_motion_encoder_state_dict(model, seed=0))
    return pack_frozen_stgcn(model.freeze().cuda(), torch.bfloat16)


@pytest.mark.parametrize("b,t", [(2, 96), (1, 37), (1, 200), (3, 62), (1, 1)])
def test_stgcn_kernels_match_plain(b, t):
    """K7 at ragged T (96: a whole forward tile of 62 frames and a ragged
    one; 200), a T shorter than one tile (37, 1), a T of exactly one
    forward tile (62) and B = 1: the forward within REL_TOL of
    `frozen_stgcn_plain`'s largest value, its masks those of the plain
    forward but for at most 0.1 % of the bits (ReLU flips between summation
    orders); the backward within REL_TOL of `stgcn_backward_plain` on the
    plain forward's masks; each a repeat bit-identical and one launch a
    st_gcn block, 10 K7 launches a call, counted by `launch_split`, tiled
    as `ops.stgcn.plan` says (the kernel's own `stgcn_plan`)."""
    pack = _stgcn_pack()
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + t)
    motion = torch.rand((b, t, 13, 2), generator=gen, device="cuda")
    dy = _rand(b, t, 64, gen=gen)
    out, masks = stgcn_forward(motion, pack, save=True)
    want, want_masks = frozen_stgcn_plain(motion, pack, torch.bfloat16, save=True)
    assert float((out - want).abs().max()) <= REL_TOL * float(want.abs().max())
    for got_m, want_m in zip(masks, want_masks):
        assert got_m.shape == want_m.shape == (10, b * t, 13) and got_m.dtype == torch.int32
        flips = int((unpack_relu_masks(got_m) != unpack_relu_masks(want_m)).sum())
        assert flips <= 1e-3 * want_m.numel() * 32, flips
    again, again_masks = stgcn_forward(motion, pack, save=True)
    assert torch.equal(again, out) and all(torch.equal(x, y) for x, y in zip(again_masks, masks))
    assert torch.equal(stgcn_forward(motion, pack), out)
    dx = stgcn_backward(dy, want_masks, pack)
    ref = stgcn_backward_plain(dy, want_masks, pack, torch.bfloat16)
    assert dx.shape == motion.shape
    assert float((dx - ref).abs().max()) <= REL_TOL * float(ref.abs().max())
    assert torch.equal(stgcn_backward(dy, want_masks, pack), dx)
    for call in (lambda: stgcn_forward(motion, pack, save=True),
                 lambda: stgcn_backward(dy, masks, pack)):
        assert sum(name.startswith("stgcn_") for name, _ in launch_split(call, 2)) == 10
    for direction in ("forward", "backward"):
        mine = plan(b, t, direction)
        assert {k: mine[k] for k in KERNEL_PLAN_KEYS} == kernel_plan(b, t, direction)


def test_stgcn_forward_keeps_only_the_masks():
    """At the stage-2 step's B = 32, T = 900, a K7 forward with ``save``
    holds, once it returns, its latents and the two masks (10, B*T, 13)
    int32, 30 MB, and nothing else: at most 40 MB in all."""
    pack = _stgcn_pack()
    gen = torch.Generator(device="cuda").manual_seed(9)
    motion = torch.rand((32, 900, 13, 2), generator=gen, device="cuda")
    stgcn_forward(motion, pack, save=True)  # build and warm up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out, masks = stgcn_forward(motion, pack, save=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    assert sum(m.numel() * 4 for m in masks) == 2 * 10 * 32 * 900 * 13 * 4
    assert held <= 40 * 2 ** 20, held


@pytest.mark.parametrize("b,t,lens,kv_dtype", [(32, 900, 60, "float32"), (2, 1800, 1800, "float32"),
                                               (3, 200, 200, "bfloat16")])
def test_linear_attention_kernel_matches_plain(b, t, lens, kv_dtype):
    """K8 at the reference-mask step's shape (B = 32, T = 900, m_lens = 60
    folded into float32 k and v), the plain-layer serving shape (B = 2,
    T = 1800, a ones mask) and, unmasked, with bf16 k and v: within 2 % of
    the plain version's largest value; deterministic; a dtype the kernel
    does not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (_rand(b, t, 128, gen=gen).to(torch.bfloat16) for _ in range(3))
    mask = None
    if kv_dtype == "float32":
        mask = (torch.arange(t, device="cuda")[None] < lens).float()[..., None].expand(b, t, 1)
    r = check_attention_kernel(q, k, v, mask, 8, reps=1)
    assert r["ok"] and r["kv_dtype"] == f"torch.{kv_dtype}", r
    kf, vf = k.float(), v.float()
    assert torch.equal(linear_attention_kernel(q, kf, vf, 8), linear_attention_kernel(q, kf, vf, 8))
    with pytest.raises(ValueError, match="linear_attention"):
        linear_attention_kernel(q, kf, v, 8)


@pytest.mark.parametrize("b,tq,tk,q_dtype,kv_dtype", [
    (2, 5, 5, "bfloat16", "float32"), (3, 7, 7, "bfloat16", "bfloat16"),
    (2, 40, 3, "float32", "float32"), (2, 33, 300, "bfloat16", "bfloat16"),
    (1, 24, 2100, "float32", "bfloat16"), (2, 1800, 1800, "bfloat16", "float32"),
])
def test_linear_attention_one_launch_at_edges(b, tq, tk, q_dtype, kv_dtype):
    """K8 at T below the cluster's 8 blocks, Tq != Tk, a rank's rows in two
    chunks, both k / v dtypes and both q dtypes: finite, within 2 % of the
    plain version's largest value, one launch a call, a repeat
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(tq + tk)
    q = _rand(b, tq, 128, gen=gen).to(getattr(torch, q_dtype))
    k, v = (_rand(b, tk, 128, gen=gen).to(getattr(torch, kv_dtype)) for _ in range(2))
    call = lambda: linear_attention_kernel(q, k, v, 8)  # noqa: E731
    got, want = call(), linear_attention_plain(q, k, v, 8)
    assert got.dtype == q.dtype and bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want.float()).abs().max()) <= REL_TOL * float(want.float().abs().max())
    assert torch.equal(got, call())
    assert len(launch_split(call, 2)) == 1


@pytest.mark.parametrize("cluster", attention.CLUSTERS)
def test_linear_attention_every_cluster_size(cluster, monkeypatch):
    """K8 with each cluster size its kernel takes (the wrapper's
    `cluster_size` pinned), at T below the cluster, Tq != Tk and the
    reference-mask step's shape with its mask: within 2 % of the plain
    version's largest value, a repeat bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setattr(attention, "cluster_size", lambda *a: cluster)
    gen = torch.Generator(device="cuda").manual_seed(cluster)
    for b, tq, tk, lens in ((2, 5, 5, 5), (2, 33, 300, 171), (32, 900, 900, 60)):
        q = _rand(b, tq, 128, gen=gen).to(torch.bfloat16)
        k, v = (_rand(b, tk, 128, gen=gen).to(torch.bfloat16) for _ in range(2))
        mask = (torch.arange(tk, device="cuda")[None] < lens).float()[..., None].expand(b, tk, 1)
        k, v = fold_key_mask(k, v, mask)
        got, want = linear_attention_kernel(q, k, v, 8), linear_attention_plain(q, k, v, 8)
        assert float((got.float() - want.float()).abs().max()) <= REL_TOL * float(
            want.float().abs().max())
        assert torch.equal(got, linear_attention_kernel(q, k, v, 8))


def test_linear_attention_allocates_only_its_output():
    """A K8 call at the reference-mask step's shape allocates its output and
    nothing else (no workspace): its peak over the memory before it is the
    output's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = _rand(32, 900, 128, gen=gen).to(torch.bfloat16)
    k, v = (_rand(32, 900, 128, gen=gen) for _ in range(2))
    linear_attention_kernel(q, k, v, 8)  # build and warm up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = linear_attention_kernel(q, k, v, 8)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == out.numel() * out.element_size()


def test_reference_mask_step_and_plain_layer_serving_run_k8():
    """``replicate_reference_mask`` on CUDA: "auto" gives bf16 plain layers
    with K8 (2 launches a step, one per layer) and K7; two steps within the
    3e-2 loss bound of the plain float32 path with the mask.  Then
    ``layer_impl="flax"`` serving: K8 2 x 5 times for ddim5, K4 launched,
    within 3 % of the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    base = Config(denoiser=DenoiserConfig(num_frames=96, num_layers=2),
                  diffusion=DiffusionConfig(steps=20, schedule="cosine"),
                  train=TrainConfig(replicate_reference_mask=True))
    mask = DDPMTrainer(base, device="cuda")
    assert (mask.cfg.denoiser.train_layer_impl, mask.cfg.denoiser.attention_impl) == ("flax", "pallas")
    plain = DDPMTrainer(base.replace(denoiser=DenoiserConfig(
        num_frames=96, num_layers=2, layer_impl="flax", music_encoder_impl="flax",
        train_layer_impl="flax", attention_impl="xla", compute_dtype="float32"),
        train=TrainConfig(replicate_reference_mask=True, feat_impl="flax")), device="cuda")
    sd = synthetic_state_dict(mask.model, seed=0)
    feat_sd = synthetic_motion_encoder_state_dict(mask.feat_model, seed=0)
    for tr in (mask, plain):
        tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    rng = np.random.RandomState(2)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(2, 288, 128)).astype(np.float32)).cuda()
    motion = torch.from_numpy(rng.uniform(0, 1, size=(2, 96, 13, 2)).astype(np.float32)).cuda()
    m_lens = torch.tensor([60, 96])
    for _ in range(2):
        drawn = {"t": rng.randint(0, 20, size=2), "noise": rng.normal(size=(2, 96, 26)),
                 "cond_keep": (rng.uniform(size=(2, 96)) > 0.1).astype(np.float32)}
        reset_launch_counts()
        mk = mask.train_step(mel, motion, m_lens, **drawn)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["linear_attention"] == 2 and counts["stgcn_backward"] == 1, counts
        mp = plain.train_step(mel, motion, m_lens, **drawn)
        for k in ("loss", "loss_mot_feat"):
            assert abs(float(mk[k]) - float(mp[k])) <= 3e-2 * abs(float(mp[k])), (k, mk, mp)
    serve = DDPMTrainer(base.replace(denoiser=DenoiserConfig(num_frames=96, num_layers=2,
                                                             layer_impl="flax")), device="cuda")
    serve.load_reference_state_dict(sd)
    plain.load_reference_state_dict(sd)
    noise = torch.from_numpy(rng.normal(size=(2, 96, 26)).astype(np.float32)).cuda()
    reset_launch_counts()
    out = serve.generate(mel, num_steps=5, noise=noise)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["linear_attention"] == 10 and counts["conv_block"] == 7, counts
    ref = plain.generate(mel, num_steps=5, noise=noise)
    assert float((out - ref).abs().max()) <= 0.03 * float(ref.abs().max())


def test_float32_stage1_step_runs_without_tf32():
    """With torch's TF32 defaults left as they are (cuDNN's on), a float32
    "lax" stage-1 step's music-encoder outputs on the card match the CPU's
    within 1e-5 of their largest element and its gradients within 1e-4:
    the trainer turns TF32 off itself.  With TF32 on, the outputs are ~2e-3
    apart and the gradients ~4e-2.  Without it, the gradients of the conv
    weights are ~5e-6 apart, and the conv biases, whose exact gradient is 0
    (the train-mode BatchNorm after each conv takes out the batch mean),
    carry ~1.5e-5 of rounding noise: hence 1e-4 for the gradients.  The
    step's four BCE terms cancel in the encoder's gradient, which puts two
    float32 summation orders ~3e-2 apart, so each encoder call's upstream
    gradient is replaced by a seeded cotangent; the backward still runs
    inside the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    assert torch.backends.cudnn.allow_tf32  # torch's default
    sd = synthetic_m2snet_state_dict(M2SNetTrainer(device="cpu").model, seed=0)
    rng = np.random.RandomState(5)
    music = torch.from_numpy(rng.uniform(0, 1, size=(2, 540, 128)).astype(np.float32))
    motion = torch.from_numpy(rng.uniform(0, 1, size=(2, 180, 13, 2)).astype(np.float32))
    got = {}
    for device in ("cpu", "cuda"):
        tr = M2SNetTrainer(sample_length=6, clip_length=2, compute_dtype="float32",
                           music_conv_impl="lax", device=device)
        tr.load_reference_state_dict(sd)
        outs, gen = [], torch.Generator().manual_seed(1)

        def hook(module, inputs, out):
            outs.append(out.detach().cpu())
            dy = torch.randn(out.shape, generator=gen).to(out.device)
            out.register_hook(lambda _: dy)

        tr.model.music_encoder.register_forward_hook(hook)
        tr.train_step(music, motion, "hard", starts=(0, 120))
        got[device] = (outs, {k: p.grad.detach().cpu()
                              for k, p in tr.model.music_encoder.named_parameters()})
    assert torch.backends.cudnn.allow_tf32  # restored
    (out_cpu, g_cpu), (out_gpu, g_gpu) = got["cpu"], got["cuda"]
    assert len(out_cpu) == len(out_gpu) == 4
    for a, b in zip(out_gpu, out_cpu):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    for k, g in g_cpu.items():
        assert float((g_gpu[k] - g).abs().max()) <= 1e-4 * gmax, k


@pytest.mark.parametrize("train_encoder", [False, True], ids=["frozen", "train_encoder"])
def test_m2sgan_step_kernel_path_matches_plain_path(train_encoder):
    """One M2SGAN step at S = 6, B = 2, two critic iterations, on "auto"
    (the kernels) and on its plain path, from the same weights, batch,
    noise and interpolation weights: with the encoder frozen the plain
    float32 path, with it training the bf16 witness (the same precision on
    cuDNN and the bf16 SyncLoss module, chip_smoke.py phase 11); every
    metric finite, ``loss_sync`` within 3e-2 relative, ``w_distance`` and
    ``loss_adv`` within 0.05 (tests/test_stage1.py:276, 337); K4 launched
    7 times and K7's forward twice and backward once with the encoder
    frozen; K4, K9, K10 (3 pools in each of 2 forwards) and K11 (3) with
    it training, the plain path none.  Then the path's encoder kernels
    against their plain versions at the step's shapes (`check_conv_blocks`
    on the frozen encoder, `check_stage1_kernels` on a generator step's
    inputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    kw = dict(sample_length=6, critic_iters=2, train_music_encoder=train_encoder, device="cuda")
    kernel = M2SGANTrainer(**kw)
    dtype = "bfloat16" if train_encoder else "float32"
    plain = M2SGANTrainer(music_encoder_impl="flax", sync_encoder_impl="flax",
                          sync_encoder_dtype=dtype, compute_dtype=dtype,
                          music_conv_impl="lax", **kw)
    assert (kernel.sync_encoder_impl, kernel.music_encoder_impl) == (
        "pallas", "flax" if train_encoder else "pallas")
    g_sd = synthetic_generator_state_dict(kernel.G, seed=0)
    d_sd = synthetic_discriminator_state_dict(kernel.D, seed=1)
    m_sd = synthetic_m2snet_state_dict(M2SNetTrainer(device="cpu").model, seed=2)
    rng = np.random.RandomState(3)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(2, 540, 128)).astype(np.float32)).cuda()
    real = torch.from_numpy(rng.uniform(0, 1, size=(2, 180, 13, 2)).astype(np.float32)).cuda()
    noise = torch.from_numpy(rng.normal(size=(2, 6, 8)).astype(np.float32)).cuda()
    alpha = {"real_fake": torch.from_numpy(rng.uniform(size=(2, 2)).astype(np.float32))}
    metrics = {}
    for name, tr in (("kernel", kernel), ("plain", plain)):
        tr.load_reference_state_dict(g_sd, d_sd, m2snet=m_sd)
        reset_launch_counts()
        m = tr.train_step(mel, real, noise=noise, gp_alpha=alpha)
        torch.cuda.synchronize()
        metrics[name] = ({k: float(v) for k, v in m.items()}, launch_counts())
    (got, counts), (want, plain_counts) = metrics["kernel"], metrics["plain"]
    assert all(np.isfinite(list(got.values()))), got
    assert abs(got["loss_sync"] - want["loss_sync"]) <= 3e-2 * abs(want["loss_sync"]), (got, want)
    for k in ("w_distance", "loss_adv"):
        assert abs(got[k] - want[k]) <= 0.05, (k, got, want)
    assert not any(plain_counts.values()), plain_counts
    if train_encoder:
        assert counts["conv_block"] > 0 and counts["conv3x3_dkernel"] > 0, counts
        assert (counts["max_pool"], counts["max_pool_bwd"]) == (6, 3), counts
        results = check_stage1_kernels(*gan_encoder_kernel_inputs(kernel, mel, real, noise),
                                       reps=1)
    else:
        assert counts["conv_block"] == 7 and counts["conv3x3_dkernel"] == 0, counts
        results = [check_conv_blocks(kernel.fused_encoder(), mel, reps=1)]
    assert (counts["stgcn_forward"], counts["stgcn_backward"]) == (2, 1), counts
    for r in results:
        assert r["ok"], r

def test_train_cli_two_steps_launch_the_training_kernels(tmp_path):
    """`python -m conductor_tpu_torch.cli.train` on the card: 2 steps of 2
    layers at B = 2, 3-s windows of 6-s clips, "auto" resolved to K5 / K6 /
    K7 and the native loader, each kernel launched every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json
    import os

    from conductor_tpu_torch.cli.train import main
    from conductor_tpu_torch.config import DatasetSpec
    from conductor_tpu_torch.data.dataset import make_synthetic_dataset

    root = str(tmp_path / "data")
    make_synthetic_dataset(root, "train", num_clips=2, spec=DatasetSpec(clip_seconds=6))
    reset_launch_counts()
    main(["--data_root", root, "--name", "cuda", "--checkpoints_dir", str(tmp_path),
          "--batch_size", "2", "--sample_length", "3", "--num_layers", "2", "--times", "2",
          "--epochs", "1", "--diffusion_steps", "20", "--schedule", "cosine"])
    counts = launch_counts()
    run = tmp_path / "ConductorMotion100" / "cuda"
    records = [json.loads(line) for line in open(run / "metrics.jsonl")]
    saved = json.load(open(run / "config.json"))
    assert [r["step"] for r in records] == [1, 2] and all(np.isfinite(r["loss"]) for r in records)
    assert (saved["denoiser"]["train_layer_impl"], saved["train"]["feat_impl"]) == (
        "pallas_fused", "pallas")
    assert (counts["decoder_layer"], counts["decoder_layer_bwd"], counts["stgcn_forward"],
            counts["stgcn_backward"]) == (4, 4, 4, 2)
    assert os.listdir(run / "ckpt") == ["2.tar"]
