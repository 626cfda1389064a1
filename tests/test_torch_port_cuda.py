"""PyTorch port on the card: every CUDA kernel against its plain version,
generate on the kernel path against the plain path, and a training step
through K5 / K6 / K7 against the plain path, at a small size (2 decoder
layers, 3.2-s clips).  Skips without a CUDA card; on one, run it with
``python -m pytest --noconftest tests/test_torch_port_cuda.py``.
``chip_smoke.py`` makes the same checks at the flagship size."""

import numpy as np
import pytest
import torch

from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
from conductor_tpu_torch.kernel_checks import (
    check_kernels,
    check_stgcn_kernels,
    check_train_kernels,
    perceptual_inputs,
)
from conductor_tpu_torch.ops import launch_counts, reset_launch_counts

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
        train_layer_impl="flax", compute_dtype="float32"),
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


def test_kernels_match_plain_versions(trainers):
    kernel, _, mel, noise = trainers
    motion = torch.rand(2, 96, 13, 2, device="cuda")
    results = check_kernels(kernel, mel, noise, reps=1) + check_train_kernels(
        kernel, mel, motion, reps=1) + check_stgcn_kernels(
        kernel, *perceptual_inputs(kernel, mel, motion), reps=1)
    assert {r["name"] for r in results} == set(launch_counts())
    for r in results:
        assert r["ok"], r


def test_generate_kernel_path_matches_plain_path(trainers):
    kernel, plain, mel, noise = trainers
    reset_launch_counts()
    out = kernel.generate(mel, num_steps=5, noise=noise)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == {"decoder_stack": 5, "sampler_prologue": 5, "sampler_epilogue": 5,
                      "conv_block": 7, "decoder_layer": 0, "decoder_layer_bwd": 0,
                      "stgcn_forward": 0, "stgcn_backward": 0}
    ref = plain.generate(mel, num_steps=5, noise=noise)
    assert out.shape == (2, 96, 26) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 0.03 * float(ref.abs().max())


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
