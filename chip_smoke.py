#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on a CUDA card.

    python3 chip_smoke.py

Phases, one line each (the kernel checks one line per kernel):
  1. environment: torch, CUDA and nvcc versions, the card's name and power
     limit as nvidia-smi gives them;
  2. build of the CUDA kernels (conductor_tpu_torch/csrc), and its time;
  3. each serving kernel (K1-K4) against its plain PyTorch version on the
     card, at the serving path's shapes (B = 2 clips of 60 s: T = 5400 mel
     frames, 1800 motion frames, D = 128, E = 512, 8 layers; K1 also in its
     bf16-VPU mode, within 0.2 %, moving with the mode at least half as far
     as the plain version and on average within a quarter of the mode's
     move of it, and K2 with int8 output and K1 in its int8-AdaLN mode on
     the int8 operands of the first ladder step, K2's codes compared
     dequantized, at most 0.1 % of them differing from the plain version's
     and none by more than 1, and all right on exact ties; K1's AdaLN GEMM
     alone in bf16 and int8 as K1 launches it, all 8 layers at once,
     beside torch.addmm with float32 out or torch._int_mm, and in device
     time beside torch.matmul in bf16 or torch._int_mm on the same
     product; K1's three modes and its GEMM again at B = 8, the
     headline's batch, and K1's device time split by launch at B = 2 and
     8, the `[k1-split]` lines; K2 (both modes) and K3 again at B = 8,
     the `[k2]` / `[k3]` lines giving each at both batches by CUDA events
     and device ms by launch (one launch a call, a repeat bit-identical
     and the tiling `ops.sampler_glue.plan` computes the kernel's
     `sampler_plan`, all three in `ok`) beside its bound and, at B = 8,
     its device-ms bar (`bar_met`); K4 on each of the encoder's 7 blocks at
     B = 2 and again at B = 8, each call's time printed and a repeat
     bit-identical), and the
     training layer kernels K5 (forward) and K6 (backward, seven
     gradients) on layer 0 of
     a training forward at B = 4 windows of 30 s (T = 900,
     padded to 960), K6 again at the stage-2 step's B = 32 (a repeat
     bit-identical, its device time split by launch, its workspace bytes,
     and beside its d_adaln_w and d_emb GEMMs one PyTorch call each on the
     same product, the `[k6]` lines), and K7, the frozen ST-GCN of the perceptual loss
     (forward on pred and target, d(pred) backward from the plain forward's
     ReLU masks against the plain backward on the same masks), on pred and
     target of one training forward at B = 32, T = 900, bf16 operands on
     both sides, a repeat bit-identical, 10 launches a call, the tiling
     `ops.stgcn.plan` reports the kernel's, and the forward's ReLU masks
     those of the plain forward but for at most 0.1 % of their bits; the
     `[k7]` lines give each direction's time by CUDA events (the forward's
     two calls apart), device ms by launch, bound (the backward's old bound
     beside it), the bytes of the masks the forward keeps and `bar_met`;
     and the stage-1 music encoder's kernels, K9 (each 3x3 conv's
     d(kernel)), K10 and K11 (each pool's forward and first-max backward)
     and K4 in its training modes (each call beside cuDNN's bf16
     `F.conv2d` on the same operands, a repeat bit-identical), on the
     inputs and cotangents of their
     calls in one train-mode forward and backward of a stage-1 step at
     B = 10 with 10-s crops (900 mel, 300 motion frames), bf16 on both
     sides; and K8, the standalone linear attention, at the shapes of its
     two paths, the reference-mask training step (B = 32, T = 900, bf16 q,
     the key mask of m_lens = 60 folded into float32 k and v) and the
     plain-layer serving path (B = 2, T = 1800, a ones mask); each output
     must agree within 2 % of the plain output's largest value, and K11
     must follow the first-max tie rule exactly (error 0 on tied inputs
     with a cotangent whose sums are exact), repeat bit for bit and launch
     one kernel a call; the `[k11]` lines give each pool's time by CUDA
     events and on the device beside its bound and autograd's max_pool2d
     backward (another tie rule), and the three pools' sums against K11's
     bars (`bar_met`); K10 must equal its plain version bit for bit,
     repeat bit for bit, launch one kernel a call and run the tiling
     `ops.max_pool.fwd_plan` computes (the kernel's `max_pool_fwd_plan`),
     the `[k10]` lines giving each pool's events and device ms beside its
     bound and `F.max_pool2d`, and the sums against K10's bars; K8 must
     repeat bit for bit and launch one kernel a call, the `[k8]` lines
     giving its events and device ms at both shapes against its bars;
  4. `DDPMTrainer.generate` on the kernel path, ddim50, on synthetic flagship
     weights and a seeded mel: a finite (2, 1800, 26) motion within 3 % of
     the plain path's on the card, with every serving kernel launched;
  5. timings: the ddim50 latency of one clip, and a 1000-step ladder over
     8 clips (bench.py's shape) timed up to the host readback;
  6. training: 4 `DDPMTrainer.train_step`s on the kernel path (K5 / K6 /
     K7, bf16) and 4 on the plain path (float32 modules and autograd), both from
     the same synthetic flagship weights and synthetic ST-GCN, on the same
     seeded mel, motion, t, noise and condition keep masks at the training
     default B = 32 windows of 30 s (T = 900 motion, 2700 mel frames); each
     kernel-path loss, and its perceptual term `loss_mot_feat` (weighted
     1e-6 in the loss, so the loss alone would not see a wrong K7), must be
     finite and within 3e-2 relative of the plain path's (the bf16 bound of
     tests/test_fused_train_path.py), K5, K6 and K7 must have launched in
     every step (K7's forward twice and its backward once), and the median
     ms per step of both paths is printed;
  7. stage 1: 4 `M2SNetTrainer.train_step`s on the kernel path ("auto" on
     CUDA: bf16, music_conv_impl "pallas_train") and 4 on the plain path
     (float32, "lax", cuDNN without TF32), from the same synthetic M2SNet
     weights, on the same seeded music (10, 2700, 128) and motion
     (10, 900, 13, 2), strategy "hard", the same starts drawn with numpy;
     each kernel-path loss must be finite and within 3e-2 relative of the
     plain path's, K4, K9, K10 and K11 must have launched in every step
     (K10 12 times: three pools in each of the step's four forwards),
     and the median ms per step of both paths is printed, with that of the
     ``share_encodes=True`` kernel-path step;
  8. training with the reference's loss mask: 4 steps of
     ``replicate_reference_mask=True``, which "auto" on CUDA must resolve
     to bf16 plain layers with the self-attention on K8 and the perceptual
     term on K7, and 4 on the plain float32 path with the mask, on phase 6's
     batch and random numbers and m_lens = 60 (the reference's value);
     each loss and `loss_mot_feat` finite and within 3e-2 relative of the
     plain path's, K8 launched num_layers = 8 times in every step and K7
     2 + 1 times, the median ms per step of both paths printed;
  9. serving on the plain layers (``layer_impl="flax"``, bf16): ddim50 at
     B = 2 on phase 4's mel and noise, within 3 % of the plain float32
     path's motion, K8 launched 8 x 50 times and K4 launched, its ms
     printed;
 10. serving under bench.py's exact config (int8 AdaLN, bf16 operands, the
     fused kernels): ddim50 at B = 2 on phase 4's mel and noise, and again
     with ``sampler_vpu_dtype="bfloat16"`` added, each within 3 % of the
     plain float32 path's motion with K2 and K1 in their int8 modes (and K1
     in its bf16-VPU mode) on all 50 steps; then bench.py's headline,
     ``ddim1000_60s_clip_motion_frames_per_sec_per_chip``: ddim1000 at
     B = 8, one untimed call, then the best of 3 timed to the host readback
     (`bench.py:64-87`), then the same on the bf16 config, both printed
     (and phase 5's one bf16 call);
 11. M2SGAN (`M2SGANTrainer`), the WGAN-GP step at the reference batch,
     B = 55 samples of 30 s (2700 mel, 900 motion frames), 5 critic
     iterations, from synthetic generator and critic weights and phase 7's
     M2SNet (its music encoder in the generator, its motion encoder the
     SyncLoss network), the same seeded noise and interpolation weights on
     every path, 4 steps each: (a) "auto" on CUDA (K4 on the frozen
     encoder, 7 launches a step; K7 bf16 in the SyncLoss, its forward on
     the fake, masks kept, and the real, its backward on the fake) beside
     the plain float32 path (the encoder on cuDNN without TF32, the flax
     SyncLoss module in float32); (b) (a) with ``cached_features`` and
     ``cached_sync_latents`` (no K4, K7's forward once), whose metrics
     must equal (a)'s bit for bit (cuDNN deterministic in this phase); (c)
     ``train_music_encoder`` on "auto" (bf16, K4's training modes, K9,
     K10 6 and K11 3 times a step) beside its witness, the same precision
     without the kernels (a bf16 generator with its encoder on cuDNN, the
     SyncLoss module in bf16), and the float32 "lax" path.  Every metric
     finite and ``loss_sync`` within 3e-2 relative of the plain path's or
     the witness's at every step; at the first step, from the same weights
     and numbers, ``w_distance`` and ``loss_adv`` within 0.05 (the JAX
     tests' one-step bound, tests/test_stage1.py:276, 337); the plain
     paths and the witness launch no kernel; each step's differences,
     (c)'s from the float32 path too, printed; the median ms a step of
     each path and its peak memory.  Phase 3 also holds phase 11's kernels
     against their plain versions at its shapes: K4 on the frozen encoder
     at B = 55, T = 2700 (`[k4] conv_block_gan`), K7 on the SyncLoss's
     inputs (`[k7] ..._gan`), and K4's training modes, K9, K10 and K11 on
     the inputs and cotangents of their calls in one generator step of
     (c) (`[k4] conv_block_train_gan`, `[k9]`, `[k10]`, `[k11]` ..._gan);
 12. the stage-2 CLI, `python -m conductor_tpu_torch.cli.train`, on a
     synthetic root of 16 60-s clips in a temporary directory (the `[cli]`
     lines): the loader must be the native one, its sequential epoch equal
     to the Python iterator's, and its ms a B = 32 batch and the batch's
     pageable copy to the card are printed; then in process (1) the CLI's
     defaults with ``--times 4 --epochs 3 --save_latest 2``, 6 steps at
     B = 32, T = 900, 1000 diffusion steps: finite losses, config.json
     resolved to ``pallas_fused`` / ``pallas`` / bf16, K5 and K6 8 times
     and K7 2 + 1 times a step, checkpoints at steps 2, 4 and 6, steps/s
     beside phase 6's bare step, and the run's peak memory; (2)
     ``--epochs 1`` then ``--continue --epochs 2`` with
     ``--cached_features`` and cuDNN deterministic, equal to a straight
     ``--epochs 2`` bit for bit (weights, Adam state, every logged loss);
     (3) a SIGTERM to a CLI subprocess: exit 0, its checkpoint at the last
     logged step, and ``--continue`` from it; (4) ``--stage1_ckpt`` from
     a synthetic reference-format M2SNet file, both encoders grafted; (5)
     ``--timestep_sampler loss-second-moment --diffusion_steps 50``, 60
     steps, every ring full; (6) ``--faithful``, 2 steps, no kernel.

Every path runs at full depth; the run takes a few minutes of its 1200-s
limit, so no path is cut.  Then one JSON line of per-kernel results (the
launch counts of K1-K4 and K1's AdaLN GEMM from phase 4, of K5 / K6 / K7
from phase 6, of K9, K10 and K11 from phase 7, of K8 from phase 8, of K1's
and K2's int8 modes, K1's bf16-VPU mode and the int8 GEMM from phase 10,
phase 11's launches of K4, K7, K9, K10 and K11 and phase 12's of K5, K6
and K7 added;
each kernel's time, its
plain version's, its bound and, where one PyTorch call computes the same
function, that call's time), the nvidia-smi line again, and as the last
line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCES = {
    "decoder_stack": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                      "conductor_tpu/ops/pallas_layer.py:262"),
    "decoder_stack_int8": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                           "conductor_tpu/ops/pallas_layer.py:262"),
    "decoder_stack_vpu_bf16": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                               "conductor_tpu/ops/pallas_layer.py:262"),
    "sampler_prologue": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                         "conductor_tpu/ops/pallas_sampler.py:80"),
    "sampler_prologue_int8": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                              "conductor_tpu/ops/pallas_sampler.py:80"),
    "sampler_epilogue": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                         "conductor_tpu/ops/pallas_sampler.py:143"),
    "conv_block": ("conductor_tpu_torch/csrc/conv_block.cu",
                   "conductor_tpu/ops/pallas_conv.py:198"),
    "decoder_layer": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                      "conductor_tpu/ops/pallas_layer.py:210"),
    "decoder_layer_bwd": ("conductor_tpu_torch/csrc/decoder_layer_bwd.cu",
                          "conductor_tpu/ops/pallas_layer_bwd.py:353"),
    "stgcn_forward": ("conductor_tpu_torch/csrc/stgcn.cu", "conductor_tpu/ops/pallas_stgcn.py:252"),
    "stgcn_backward": ("conductor_tpu_torch/csrc/stgcn.cu", "conductor_tpu/ops/pallas_stgcn.py:280"),
    "conv3x3_dkernel": ("conductor_tpu_torch/csrc/conv_train.cu",
                        "conductor_tpu/ops/conv_train.py:104"),
    "max_pool": ("conductor_tpu_torch/csrc/max_pool.cu", "conductor_tpu/ops/pallas_pool.py:163"),
    "max_pool_bwd": ("conductor_tpu_torch/csrc/max_pool.cu", "conductor_tpu/ops/pallas_pool.py:352"),
    "linear_attention": ("conductor_tpu_torch/csrc/linear_attention.cu",
                         "conductor_tpu/ops/pallas_attention.py:152"),
    # K1's AdaLN modulation (`_layer_body` :112-120), launched by K1 once a call
    "adaln_modulation": ("conductor_tpu_torch/csrc/adaln_gemm.cu",
                         "conductor_tpu/ops/pallas_layer.py:262"),
    "adaln_modulation_int8": ("conductor_tpu_torch/csrc/adaln_gemm.cu",
                              "conductor_tpu/ops/pallas_layer.py:262"),
}
# the AdaLN GEMM's device time beside its yardstick's, in its kernels-line entries
YARDSTICK_KEYS = ("device_ms", "yardstick", "yardstick_device_ms", "no_slower_than_yardstick")
# K1's modes, with their rows of the per-launch split (`k1_launch_split`)
K1_MODES = ("decoder_stack", "decoder_stack_vpu_bf16", "decoder_stack_int8")
SERVING_KERNELS = ("decoder_stack", "sampler_prologue", "sampler_epilogue", "conv_block")
# bench.py's serving config (bench.py:41-50), applied to the port's Config()
BENCH_DENOISER = dict(attention_impl="pallas", compute_dtype="bfloat16", layer_impl="pallas_fused",
                      sampler_adaln_int8=True, music_encoder_impl="pallas")
TRAIN_KERNELS = ("decoder_layer", "decoder_layer_bwd", "stgcn_forward", "stgcn_backward")
K7_PER_STEP = (2, 1)  # K7's forward (pred, target) and backward calls in a stage-2 step
STAGE1_KERNELS = ("conv_block", "conv3x3_dkernel", "max_pool", "max_pool_bwd")
K10_PER_STEP = 12  # K10's calls in a stage-1 step: 3 pools in each of its 4 music forwards
# stage 1's batch, sample and crop seconds (conductor_tpu/cli/train_m2snet.py)
STAGE1_B, STAGE1_S, STAGE1_C = 10, 30, 10
REFERENCE_M_LENS = 60  # the reference's m_lens (conductor_tpu_torch/config.py TrainConfig)
GENERATE_REL_TOL = 0.03  # ladder drift bound of tests/test_fused_denoiser.py
TRAIN_LOSS_REL_TOL = 3e-2  # bf16 loss bound of tests/test_fused_train_path.py
TRAIN_STEPS = 4
# M2SGAN: the reference batch, sample seconds and critic iterations
# (M2SGAN_train.py:168-196)
GAN_B, GAN_S, GAN_ITERS = 55, 30, 5
GAN_KERNELS = ("conv_block", "conv3x3_dkernel", "max_pool", "max_pool_bwd", "stgcn_forward",
               "stgcn_backward")
GAN_ADV_TOL = 0.05  # w_distance and loss_adv, tests/test_stage1.py:276, 337
# phase 12: the stage-2 CLI on a synthetic root of 60-s clips; 16 clips
# give 16 windows an epoch, 2 batches of 32 with --times 4
CLI_CLIPS = 16
CLI_KERNELS = ("decoder_layer", "decoder_layer_bwd", "stgcn_forward", "stgcn_backward")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn().cpu()  # up to the host readback
    return out, time.perf_counter() - t0


def cli_phase(smi: str, bare_step_s: float) -> dict[str, int]:
    """Phase 12: `python -m conductor_tpu_torch.cli.train` on a synthetic
    root, in process unless a signal is sent; returns the launches of K5 /
    K6 / K7 in its default run.  Raises SystemExit on any failed check."""
    import os
    import shutil
    import signal
    import tempfile

    from conductor_tpu_torch.cli.train import main as train_cli
    from conductor_tpu_torch.data.dataset import (
        BatchIterator,
        ConductorMotionDataset,
        make_synthetic_dataset,
    )
    from conductor_tpu_torch.data.native_loader import make_batch_iterator
    from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
    from conductor_tpu_torch.models.m2snet import M2SNet
    from conductor_tpu_torch.ops import launch_counts, reset_launch_counts
    from conductor_tpu_torch.train.checkpoints import CheckpointManager

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        root = os.path.join(work, "data")
        make_synthetic_dataset(root, "train", num_clips=CLI_CLIPS)

        # (1) the loader: native, its sequential epoch the Python one's, and
        # its time a B = 32 random-window batch, and the copy to the card
        seq = ConductorMotionDataset(root, "train", 30, "sequential")
        native = make_batch_iterator(seq, 8, shuffle=False)
        if native.kind != "native":
            raise SystemExit(f"chip_smoke: the native loader was not chosen: "
                             f"{getattr(native, 'fallback_reason', '')}")
        nb, pb = list(native), list(BatchIterator(seq, 8, shuffle=False))
        if len(nb) != len(pb) or not all(np.array_equal(x, y) for a, b in zip(nb, pb)
                                         for x, y in zip(a, b)):
            raise SystemExit("chip_smoke: the native loader's epoch differs from the Python one's")
        native.close()
        loader = make_batch_iterator(ConductorMotionDataset(root, "train", 30, "random"), 32,
                                     seed=1, times=4)
        batch_s, copy_s = [], []
        for epoch in range(4):
            loader.epoch = epoch
            t0 = time.perf_counter()
            for mel, motion, m_lens in loader:
                batch_s.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                torch.tensor(mel).to("cuda")  # the step's copy: pageable host memory
                torch.tensor(motion).to("cuda")
                torch.cuda.synchronize()
                copy_s.append(time.perf_counter() - t1)
                t0 = time.perf_counter()
        loader.close()
        mb = (mel.nbytes + motion.nbytes) / 1e6
        print(f"[cli] loader: native, its sequential epoch equal to the Python iterator's "
              f"({len(nb)} batches of 8); B=32 random windows: median {np.median(batch_s) * 1e3:.2f} "
              f"ms a batch from the loader (max {max(batch_s) * 1e3:.2f}, {len(batch_s)} batches), "
              f"host-to-device copy of its {mb:.1f} MB median {np.median(copy_s) * 1e3:.2f} ms "
              f"(max {max(copy_s) * 1e3:.2f}) on {smi}")

        def run(name, *extra):
            """One in-process CLI run; its run directory, the launches of the
            path's kernels and its wall seconds."""
            reset_launch_counts()
            t0 = time.perf_counter()
            train_cli(["--data_root", root, "--name", name, "--checkpoints_dir", work, *extra])
            torch.cuda.synchronize()
            return (os.path.join(work, "ConductorMotion100", name), launch_counts(),
                    time.perf_counter() - t0)

        def records(run_dir):
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                return [json.loads(line) for line in f]

        def final(run_dir):
            return CheckpointManager(os.path.join(run_dir, "ckpt")).restore()

        # (2) the defaults: B = 32, 30-s windows, 1000 steps, "auto"; 6 steps
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run_dir, cli_counts, wall = run("defaults", "--times", "4", "--epochs", "3",
                                        "--save_latest", "2")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        recs = records(run_dir)
        with open(os.path.join(run_dir, "config.json")) as f:
            saved = json.load(f)
        impls = (saved["denoiser"]["train_layer_impl"], saved["train"]["feat_impl"],
                 saved["denoiser"]["compute_dtype"])
        per_step = {k: cli_counts[k] for k in CLI_KERNELS}
        steps = [r["step"] for r in recs]
        t_steps = [r["t"] for r in recs]
        steady = (t_steps[-1] - t_steps[1]) / (len(t_steps) - 2)  # steps 3-6, saves included
        step_ms = [round((b - a) * 1e3, 1) for a, b in zip(t_steps, t_steps[1:])]
        print(f"[cli] defaults (B=32, T=900, 1000 steps, --times 4 --epochs 3): steps {steps}, "
              f"losses {[r['loss'] for r in recs]}, config {impls}, launches {per_step}, "
              f"{1 / steady:.2f} steps/s over steps 3-6 ({steady * 1e3:.1f} ms a step, "
              f"checkpoint saves included; steps 2-6 {step_ms} ms apart; phase 6's bare step "
              f"{bare_step_s * 1e3:.1f} ms, "
              f"{1 / bare_step_s:.2f} steps/s), run wall {wall:.1f} s, peak memory above the "
              f"phases before {peak:.2f} GiB on {smi}")
        if steps != list(range(1, 7)) or not all(np.isfinite(r["loss"]) for r in recs):
            raise SystemExit(f"chip_smoke: the CLI's default run went wrong: {recs}")
        if impls != ("pallas_fused", "pallas", "bfloat16"):
            raise SystemExit(f"chip_smoke: the CLI did not resolve 'auto' to the kernels: {impls}")
        if per_step != {"decoder_layer": 48, "decoder_layer_bwd": 48, "stgcn_forward": 12,
                        "stgcn_backward": 6}:
            raise SystemExit(f"chip_smoke: the CLI did not launch K5 / K6 / K7 every step: "
                             f"{per_step}")
        if CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps() != [2, 4, 6]:
            raise SystemExit("chip_smoke: the CLI's default run did not save steps 2, 4, 6")

        # (3) resume from an epoch boundary, cached features, cuDNN
        # deterministic: --epochs 1 then --continue --epochs 2 equals a
        # straight --epochs 2 bit for bit
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            common = ["--times", "4", "--cached_features"]
            straight, _, _ = run("straight", *common, "--epochs", "2")
            resumed, _, _ = run("resumed", *common, "--epochs", "1")
            run("resumed", *common, "--epochs", "2", "--continue")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        a, b = final(straight), final(resumed)
        same = a["total_it"] == b["total_it"] == 4 and all(
            torch.equal(v, b["encoder"][k]) for k, v in a["encoder"].items()) and all(
            torch.equal(v, b["opt_encoder"]["state"][i][key])
            for i, st in a["opt_encoder"]["state"].items() for key, v in st.items())
        losses_a = [r["loss"] for r in records(straight)]
        losses_b = [r["loss"] for r in records(resumed)]
        print(f"[cli] resume at step 2 (cached features): losses straight {losses_a}, resumed "
              f"{losses_b}; final weights and Adam state bit-equal: {same}")
        if not same or losses_a != losses_b:
            raise SystemExit("chip_smoke: the resumed CLI run differs from the straight one")

        # (4) SIGTERM to a CLI process: a checkpoint at the logged step, rc 0
        argv = [sys.executable, "-m", "conductor_tpu_torch.cli.train", "--data_root", root,
                "--name", "sigterm", "--checkpoints_dir", work, "--times", "4",
                "--cached_features", "--epochs", "1000"]
        sig_dir = os.path.join(work, "ConductorMotion100", "sigterm")
        jsonl = os.path.join(sig_dir, "metrics.jsonl")
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.time() + 120
            while not (os.path.exists(jsonl) and os.path.getsize(jsonl) > 0):
                if proc.poll() is not None or time.time() > deadline:
                    raise SystemExit(f"chip_smoke: the CLI process logged no step: "
                                     f"{proc.communicate()[0][-2000:]}")
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=120)
        finally:
            proc.kill()
            proc.wait()
        last = records(sig_dir)[-1]["step"]
        saved_step = CheckpointManager(os.path.join(sig_dir, "ckpt")).latest_step()
        run("sigterm", "--times", "4", "--cached_features", "--epochs", str(last // 2 + 2),
            "--continue")
        after = [r["step"] for r in records(sig_dir)]
        print(f"[cli] SIGTERM after step {last}: rc {proc.returncode}, latest checkpoint "
              f"{saved_step}; --continue logged steps {after[after.index(last) + 1:]}")
        if proc.returncode != 0 or saved_step != last or after[-1] <= last:
            raise SystemExit(f"chip_smoke: SIGTERM did not checkpoint and resume: {out[-2000:]}")

        # (5) the stage-1 graft from a reference-format M2SNet file
        m2s = synthetic_m2snet_state_dict(M2SNet(), seed=1)
        torch.save({k: torch.from_numpy(v) for k, v in m2s.items()}, os.path.join(work, "m2snet.pt"))
        graft_dir, graft_counts, _ = run("graft", "--times", "2", "--epochs", "1",
                                         "--stage1_ckpt", os.path.join(work, "m2snet.pt"))
        g = final(graft_dir)
        grafted = all(np.array_equal(g["encoder"][k].numpy(), v) for k, v in m2s.items()
                      if k.startswith("music_encoder.")) and all(
            np.array_equal(g["feat_encoder"][k.removeprefix("motion_encoder.")].numpy(), v)
            for k, v in m2s.items() if k.startswith("motion_encoder."))
        g_loss = records(graft_dir)[-1]["loss"]
        print(f"[cli] --stage1_ckpt: encoders grafted {grafted}, loss {g_loss}, K7 launches "
              f"{graft_counts['stgcn_forward']} + {graft_counts['stgcn_backward']}")
        if not grafted or not np.isfinite(g_loss) or graft_counts["stgcn_backward"] != 1:
            raise SystemExit("chip_smoke: the stage-1 graft went wrong")

        # (6) the loss-second-moment sampler over 50 timesteps, to a full ring
        lsm_dir, _, lsm_wall = run("lsm", "--timestep_sampler", "loss-second-moment",
                                   "--diffusion_steps", "50", "--times", "40", "--epochs", "3",
                                   "--cached_features", "--save_latest", "1000")
        st = final(lsm_dir)["sampler_state"]
        full = int((st["loss_counts"] == 10).sum())
        lsm_losses = [r["loss"] for r in records(lsm_dir)]
        print(f"[cli] loss-second-moment, 50 timesteps: {len(lsm_losses)} steps in {lsm_wall:.1f} s, "
              f"{full} of 50 rings full, last loss {lsm_losses[-1]}")
        if full != 50 or not all(np.isfinite(lsm_losses)):
            raise SystemExit("chip_smoke: the loss-second-moment sampler did not fill its rings")

        # (7) --faithful: the plain float32 path, which launches no kernel
        faithful_dir, faithful_counts, faithful_wall = run("faithful", "--faithful", "--times", "2",
                                                           "--epochs", "2")
        f_losses = [r["loss"] for r in records(faithful_dir)]
        print(f"[cli] --faithful: 2 steps in {faithful_wall:.1f} s, losses {f_losses}, launches "
              f"{sum(faithful_counts.values())}")
        if any(faithful_counts.values()) or len(f_losses) != 2 or not all(np.isfinite(f_losses)):
            raise SystemExit(f"chip_smoke: --faithful launched a kernel: {faithful_counts}")
        return per_step
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from conductor_tpu_torch import DDPMTrainer, M2SGANTrainer, M2SNetTrainer
    from conductor_tpu_torch.config import Config, DenoiserConfig, TrainConfig
    from conductor_tpu_torch.interop import (
        synthetic_discriminator_state_dict,
        synthetic_generator_state_dict,
        synthetic_m2snet_state_dict,
        synthetic_motion_encoder_state_dict,
        synthetic_state_dict,
    )
    from conductor_tpu_torch.kernel_checks import (
        K7_BAR_MS,
        K7_MASK_FLIP_SHARE,
        K8_BAR_DEVICE_MS,
        K10_BAR_DEVICE_MS,
        K10_BAR_MS,
        K11_BAR_DEVICE_MS,
        K11_BAR_MS,
        check_attention_kernel,
        check_conv_blocks,
        check_kernels,
        check_layer_bwd,
        check_stack_kernels,
        check_stage1_kernels,
        check_stgcn_kernels,
        check_train_kernels,
        gan_encoder_kernel_inputs,
        k1_launch_split,
        ladder_step_inputs,
        perceptual_inputs,
        stack_operands,
        stage1_kernel_inputs,
        sync_loss_inputs,
        time_ms,
    )
    from conductor_tpu_torch.ops import (
        _build,
        fused_decoder_stack,
        launch_counts,
        part_launch_counts,
        reset_launch_counts,
    )

    # the plain references run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc}' device '{torch.cuda.get_device_name(0)}'")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log().read_text().splitlines() if "registers" in ln]
    print(f"[build] {time.perf_counter() - t0:.1f} s ({len(ptxas)} kernels: "
          f"{'; '.join(ptxas)})")

    cfg = Config()  # flagship: D = 128, 8 layers, 8 heads, ff 64, 1000 linear steps
    kernel_tr = DDPMTrainer(cfg, device="cuda")  # "auto" on CUDA: the kernel path
    if kernel_tr.fused is None or kernel_tr.fused_encoder is None:
        raise SystemExit("chip_smoke: 'auto' did not select the kernel path on CUDA")
    if (kernel_tr.cfg.denoiser.train_layer_impl, kernel_tr.cfg.train.feat_impl) != (
            "pallas_fused", "pallas"):
        raise SystemExit("chip_smoke: 'auto' did not select the training kernels on CUDA")
    plain_cfg = cfg.replace(denoiser=DenoiserConfig(
        layer_impl="flax", music_encoder_impl="flax", train_layer_impl="flax",
        attention_impl="xla", compute_dtype="float32"), train=TrainConfig(feat_impl="flax"))
    plain_tr = DDPMTrainer(plain_cfg, device="cuda")
    sd = synthetic_state_dict(kernel_tr.model, seed=0)
    feat_sd = synthetic_motion_encoder_state_dict(kernel_tr.feat_model, seed=0)
    kernel_tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    plain_tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(2, 5400, 128)).astype(np.float32)).cuda()
    noise = torch.from_numpy(rng.normal(size=(2, 1800, 26)).astype(np.float32)).cuda()

    # the training batch: B = 32 windows of 30 s, and each step's random
    # numbers, made on the host from the seed
    n_train, t_train = cfg.train.batch_size, cfg.train.sample_length * cfg.dataset.motion_hz
    mel_train = torch.from_numpy(rng.uniform(
        0, 1, size=(n_train, 3 * t_train, 128)).astype(np.float32)).cuda()
    motion_train = torch.from_numpy(rng.uniform(
        0, 1, size=(n_train, t_train, 13, 2)).astype(np.float32)).cuda()
    drawn = [{"t": rng.randint(0, cfg.diffusion.steps, size=n_train),
              "noise": rng.normal(size=(n_train, t_train, 26)).astype(np.float32),
              "cond_keep": (rng.uniform(size=(n_train, t_train)) >= 0.1).astype(np.float32)}
             for _ in range(TRAIN_STEPS)]

    # stage 1: the kernel and plain trainers on one synthetic M2SNet, a
    # seeded batch of 30-s samples and the "hard" starts of each step
    m2s_kernel = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, device="cuda")
    if (m2s_kernel.compute_dtype, m2s_kernel.music_conv_impl) != ("bfloat16", "pallas_train"):
        raise SystemExit("chip_smoke: 'auto' did not select the stage-1 kernels on CUDA")
    m2s_plain = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, compute_dtype="float32",
                              music_conv_impl="lax", device="cuda")
    m2s_sd = synthetic_m2snet_state_dict(m2s_kernel.model, seed=0)
    music = torch.from_numpy(rng.uniform(
        0, 1, size=(STAGE1_B, STAGE1_S * 90, 128)).astype(np.float32)).cuda()
    motion_s1 = torch.from_numpy(rng.uniform(
        0, 1, size=(STAGE1_B, STAGE1_S * 30, 13, 2)).astype(np.float32)).cuda()
    span = (STAGE1_S - STAGE1_C) * 30  # the "hard" ranges of data/pairs.py
    starts = []
    for _ in range(TRAIN_STEPS):
        s1 = int(rng.randint(0, span - 300))
        starts.append((s1, int(rng.randint(s1 + 300, span))))

    # M2SGAN: the "auto" trainer (K4 frozen encoder, K7 bf16 SyncLoss), the
    # synthetic generator and critic, phase 7's M2SNet, a seeded batch of
    # 30-s samples and each step's noise and interpolation weights
    gan = M2SGANTrainer(critic_iters=GAN_ITERS, device="cuda")
    if (gan.music_encoder_impl, gan.sync_encoder_impl, gan.sync_encoder_dtype,
            gan.compute_dtype) != ("pallas", "pallas", "bfloat16", "float32"):
        raise SystemExit("chip_smoke: 'auto' did not select the M2SGAN kernels on CUDA")
    gan_sd = (synthetic_generator_state_dict(gan.G, seed=0),
              synthetic_discriminator_state_dict(gan.D, seed=1))
    gan.load_reference_state_dict(*gan_sd, m2snet=m2s_sd)

    def gan_trainer(**kw):
        tr = M2SGANTrainer(critic_iters=GAN_ITERS, device="cuda", **kw)
        tr.load_reference_state_dict(*gan_sd, m2snet=m2s_sd)
        return tr

    gan_mel = torch.from_numpy(rng.uniform(
        0, 1, size=(GAN_B, GAN_S * 90, 128)).astype(np.float32)).cuda()
    gan_real = torch.from_numpy(rng.uniform(
        0, 1, size=(GAN_B, GAN_S * 30, 13, 2)).astype(np.float32)).cuda()
    gan_drawn = [(torch.from_numpy(rng.normal(size=(GAN_B, GAN_S, 8)).astype(np.float32)).cuda(),
                  {"real_fake": torch.from_numpy(rng.uniform(size=(GAN_ITERS, GAN_B))
                                                 .astype(np.float32))})
                 for _ in range(TRAIN_STEPS)]

    # 3. every kernel against its plain version, at the main paths' shapes;
    # K1 and its AdaLN GEMM also at B = 8 (the headline's batch), on a mel
    # and x_T of their own seed, and K1's device time by launch at both
    rng8 = np.random.RandomState(8)
    mel_b8 = torch.from_numpy(rng8.uniform(0, 1, size=(8, 5400, 128)).astype(np.float32)).cuda()
    noise_b8 = torch.from_numpy(rng8.normal(size=(8, 1800, 26)).astype(np.float32)).cuda()
    results = check_kernels(kernel_tr, mel, noise, glue_inputs=(mel_b8, noise_b8))
    step_b8 = ladder_step_inputs(kernel_tr, mel_b8, noise_b8)[:2]
    results += check_stack_kernels(kernel_tr, *step_b8, suffix="_b8")
    results.append(check_conv_blocks(kernel_tr.fused_encoder, mel_b8) | {"name": "conv_block_b8"})
    for label, (m, x_t) in (("B=2", (mel, noise)), ("B=8", (mel_b8, noise_b8))):
        ops = stack_operands(kernel_tr, *ladder_step_inputs(kernel_tr, m, x_t)[:2])
        for mode in K1_MODES:
            args, kw = ops[mode]
            split = k1_launch_split(lambda: fused_decoder_stack(*args, **kw))
            print(f"[k1-split] {mode} {label} T=1800, device ms a call: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f", sum {sum(split.values()):.4f} ({smi})")
    del mel_b8, noise_b8, step_b8, ops, args, kw
    results += check_train_kernels(kernel_tr, mel_train[:4], motion_train[:4])
    results[-1]["name"] = "decoder_layer_bwd_b4"  # the main path's K6 call is B = 32's
    results.append(check_layer_bwd(kernel_tr, mel_train, motion_train))
    feat_mxu = getattr(torch, kernel_tr.cfg.denoiser.compute_dtype)
    results += check_stgcn_kernels(kernel_tr.feat_model, kernel_tr.feat_pack, feat_mxu,
                                   *perceptual_inputs(kernel_tr, mel_train, motion_train))
    m2s_kernel.load_reference_state_dict(m2s_sd)
    results += check_stage1_kernels(*stage1_kernel_inputs(m2s_kernel, music, motion_s1, starts[0]))
    m2s_kernel.load_reference_state_dict(m2s_sd)  # undo the check's BN statistics
    # M2SGAN's kernels at phase 11's shapes: K4 on the frozen encoder (a),
    # K7 on the SyncLoss's inputs, and the trainable encoder's kernels
    # (K4's training modes, K9, K10, K11) in a generator step of (c)
    results.append(check_conv_blocks(gan.fused_encoder(), gan_mel) | {"name": "conv_block_gan"})
    results += check_stgcn_kernels(gan.sync_encoder, gan.sync_pack(), gan.sync_dtype,
                                   *sync_loss_inputs(gan, gan_mel, gan_real, gan_drawn[0][0]),
                                   suffix="_gan")
    trains = gan_trainer(train_music_encoder=True)
    results += [r | {"name": r["name"] + "_gan"} for r in check_stage1_kernels(
        *gan_encoder_kernel_inputs(trains, gan_mel, gan_real, gan_drawn[0][0]))]
    del trains
    torch.cuda.empty_cache()
    heads = cfg.denoiser.num_heads
    for b, t, lens, name, bar in (
            (n_train, t_train, REFERENCE_M_LENS, "linear_attention", K8_BAR_DEVICE_MS["mask"]),
            (2, 1800, 1800, "linear_attention_serving", K8_BAR_DEVICE_MS["serving"])):
        q, k, v = (torch.from_numpy(rng.normal(size=(b, t, 128)).astype(np.float32)).cuda()
                   .to(torch.bfloat16) for _ in range(3))
        key_mask = (torch.arange(t, device="cuda")[None] < lens).float()[..., None].expand(b, t, 1)
        results.append(check_attention_kernel(q, k, v, key_mask, heads, bar_device_ms=bar)
                       | {"name": name, "bar_device_ms": bar})
    for r in results:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        shape = f" {r['shape']}" if "shape" in r and "kv_dtype" not in r else ""
        print(f"[kernel] {r['name']}{shape}: max_abs_err {r['max_abs_err']:.6g} "
              f"(plain max {r['ref_max_abs']:.6g}, {'ok' if r['ok'] else 'FAIL'}) "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"library {lib}")
        if r["name"].startswith("decoder_layer_bwd"):
            for name, (e, m) in zip(("dx", "demb", "dkvc", "dmats", "dvecs", "daw", "dab"),
                                    r["parts"]):
                print(f"[kernel]   {r['name']} {name}: err {e:.6g} (max {m:.6g})")
            print(f"[k6] {r['shape']}: repeat bit-identical {r['repeat_identical']}; device "
                  f"{r['device_ms']:.4f} ms a call by launch: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in r["launch_split"])
                  + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); workspace "
                  f"{r['workspace_bytes']} bytes; yardsticks, device ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in r["yardsticks"].items())
                  + "; GEMM launches' bounds: "
                  + ", ".join(f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})"
                              for k, v in r["part_bounds"].items()) + f" ({smi})")
        k7, gan_k7 = r["name"].removesuffix("_gan"), r["name"].endswith("_gan")
        if k7 == "stgcn_backward":
            print(f"[kernel]   {r['name']} after the kernel's own forward (ReLU masks of "
                  f"another summation order): err {r['e2e_err']:.6g}, not bounded")
        if k7 in ("stgcn_forward", "stgcn_backward"):
            calls = "".join(f"; {k} {v:.4f} ms" for k, v in r.get("calls_ms", {}).items())
            old = r.get("old_bound")
            extra = (f"; old bound {old['bound_ms']:.4f} ms ({old['bound_by']})" if old else
                     f"; masks kept {r['mask_bytes']} bytes, {r['mask_flips']} of their "
                     f"{r['mask_bits']} bits other than the plain forward's (at most "
                     f"{K7_MASK_FLIP_SHARE:g} of them)")
            shape = (f"B={GAN_B} T={GAN_S * 30} (M2SGAN SyncLoss: the fake, the real)" if gan_k7
                     else f"B={n_train} T={t_train}")
            bar = "" if gan_k7 else f" (bar <= {K7_BAR_MS}: bar_met {r['bar_met']})"
            print(f"[k7] {r['name']} {shape}: {r['ms']:.4f} ms a call by CUDA events"
                  f"{calls}{bar}; device "
                  f"{r['device_ms']:.4f} ms in {len(r['launch_split'])} launches, "
                  f"{r['launches_a_call']} of them K7's: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in r["launch_split"])
                  + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}; repeat "
                  f"bit-identical {r['repeat_identical']}; plan the kernel's {r['plan_ok']} ({smi})")
        if "yardstick" in r:
            print(f"[kernel]   {r['name']}{shape}: device ms {r['device_ms']:.4f}, "
                  f"{r['yardstick']} {r['yardstick_device_ms']:.4f}: no slower than it: "
                  f"{r['no_slower_than_yardstick']}")
        if "kv_dtype" in r:
            print(f"[kernel]   {r['name']} {r['shape']}: bf16 q, k and v {r['kv_dtype']}")
            print(f"[k8] {r['name']} {r['shape']}, k and v {r['kv_dtype']}, clusters of "
                  f"{r['cluster']}: {r['ms']:.4f} ms a call by CUDA events, device "
                  f"{r['device_ms']:.4f} ms (bar <= {r['bar_device_ms']}), "
                  f"{r['launches_a_call']} launch a call, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), repeat bit-identical "
                  f"{r['repeat_identical']}: bar_met {r['bar_met']} ({smi})")
        if "tie_err" in r:
            print(f"[kernel]   max_pool_bwd on tied inputs: err {r['tie_err']:.6g} (must be 0)")
        if r["name"].startswith("sampler_"):
            bar = ("" if r["bar_device_ms"] is None else
                   f" (bar <= {r['bar_device_ms']}: bar_met {r['bar_met']})")
            print(f"[{'k3' if 'epilogue' in r['name'] else 'k2'}] {r['name']} B={r['shape'][0]} "
                  f"T={r['shape'][1]}: {r['ms']:.4f} ms a call by CUDA events, device "
                  f"{r['device_ms']:.4f} ms{bar}, {r['launches_a_call']} launch a call, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), repeat bit-identical "
                  f"{r['repeat_identical']}, plan {r['plan']} the kernel's {r['plan_ok']} ({smi})")
        if "codes_differ" in r:
            print(f"[kernel]   {r['name']} codes: {r['codes_differ']} of {r['n_codes']} "
                  f"differ from the plain version's (at most 0.1 % may), by at most "
                  f"{r['code_max_diff']} (must be <= 1); wrong codes on exact ties: "
                  f"{r['tie_errors']} (must be 0)")
        if "mode_gap" in r:
            print(f"[kernel]   decoder_stack_vpu_bf16: the mode moves the plain output by "
                  f"{r['mode_gap']:.6g} at most, {r['mean_mode_gap']:.6g} on average, and the "
                  f"kernel's by {r['kernel_gap']:.6g} (must be >= half the largest); the "
                  f"kernel's mean distance from the plain version: {r['mean_abs_err']:.6g} "
                  f"(must be <= a quarter of the mean move)")
        for c in r.get("calls", []):
            lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
            extra = ""
            if "repeat_identical" in c:  # K4: beside its library call, a repeat
                if c["library_ms"] is not None:
                    extra = f" (kernel no slower: {c['ms'] <= c['library_ms']})"
                extra += f"; repeat bit-identical {c['repeat_identical']}"
            edge = f" {c['edge']}" if "edge" in c else ""
            print(f"[kernel]   {r['name']} {c.get('shape', '')}{edge}: err {c['max_abs_err']:.6g} "
                  f"(max {c['ref_max_abs']:.6g}) kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} "
                  f"ms bound {c['bound_ms']:.4f} ms library {lib}{extra}")
        # the trainable encoder's kernels at stage 1's shapes or M2SGAN's
        # (``_gan``, B = 55 samples of 30 s, where the bars do not apply)
        base, gan_s1 = r["name"].removesuffix("_gan"), r["name"].endswith("_gan")
        where = (f"M2SGAN B={GAN_B} T={GAN_S * 90}" if gan_s1 else
                 f"stage 1 B={STAGE1_B} crops T={STAGE1_C * 90}")
        if base == "conv3x3_dkernel":
            print(f"[k9] {r['name']} {where}: {len(r['calls'])} calls, {r['ms']:.4f} ms by CUDA "
                  f"events, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), library {r['library_ms']:.4f} ms, max_abs_err "
                  f"{r['max_abs_err']:.6g} (plain max {r['ref_max_abs']:.6g}): ok {r['ok']} ({smi})")
        if base == "max_pool_bwd":
            for c in r["calls"]:
                print(f"[k11] pool {c['pool']} x {c['shape']}: {c['ms']:.4f} ms by CUDA events, "
                      f"device {c['device_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                      f"({c['bound_by']}), {c['launches_a_call']} launch a call, repeat "
                      f"bit-identical {c['repeat_identical']}; autograd's max_pool2d backward "
                      f"(another tie rule, not a yardstick) {c['reference_ms']:.4f} ms ({smi})")
            bars = ("" if gan_s1 else f" (bar <= {K11_BAR_MS})",
                    "" if gan_s1 else f" (bar <= {K11_BAR_DEVICE_MS})",
                    "" if gan_s1 else f", bar_met {r['bar_met']}")
            print(f"[k11] {r['name']} {where}, 3 pools: {r['ms']:.4f} ms by CUDA events{bars[0]}, "
                  f"device {r['device_ms']:.4f} ms{bars[1]}, bound {r['bound_ms']:.4f} ms, tie_err "
                  f"{r['tie_err']:.6g}: ok {r['ok']}{bars[2]} ({smi})")
        if base == "max_pool":
            for c in r["calls"]:
                print(f"[k10] pool {c['pool']} x {c['shape']}: {c['ms']:.4f} ms by CUDA events, "
                      f"device {c['device_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                      f"({c['bound_by']}), F.max_pool2d {c['library_ms']:.4f} ms, "
                      f"{c['launches_a_call']} launch a call, err {c['max_abs_err']:.6g} (must "
                      f"be 0), repeat bit-identical {c['repeat_identical']}, plan {c['plan']} the "
                      f"kernel's {c['plan_ok']} ({smi})")
            bars = ("" if gan_s1 else f" (bar <= {K10_BAR_MS})",
                    "" if gan_s1 else f" (bar <= {K10_BAR_DEVICE_MS})",
                    "" if gan_s1 else f", bar_met {r['bar_met']}")
            print(f"[k10] {r['name']} {where}, 3 pools: {r['ms']:.4f} ms by CUDA events{bars[0]}, "
                  f"device {r['device_ms']:.4f} ms{bars[1]}, bound {r['bound_ms']:.4f} ms, "
                  f"F.max_pool2d {r['library_ms']:.4f} ms: ok {r['ok']}{bars[2]} ({smi})")
        if r["name"].startswith("conv_block"):
            lib = "" if r["library_ms"] is None else (
                f"; library {r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f} ms")
            print(f"[k4] {r['name']} (first input {r['calls'][0]['shape']}): {len(r['calls'])} calls, "
                  f"{r['ms']:.4f} ms by CUDA events, device {r['device_ms']:.4f} ms{lib}, max_abs_err "
                  f"{r['max_abs_err']:.6g} (plain max {r['ref_max_abs']:.6g}): ok {r['ok']} ({smi})")
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")

    # 4. the main path: generate through the kernels, ddim50, B = 2
    reset_launch_counts()
    out = kernel_tr.generate(mel, num_steps=50, noise=noise)
    torch.cuda.synchronize()
    counts = launch_counts()
    counts["adaln_modulation"] = part_launch_counts()["adaln_modulation"]
    ref = plain_tr.generate(mel, num_steps=50, noise=noise)
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    finite = bool(torch.isfinite(out).all())
    print(f"[generate] ddim50 B=2 shape {tuple(out.shape)} finite {finite} "
          f"max_abs_err vs plain {err:.6g} (plain max {scale:.6g}) launches {counts}")
    if tuple(out.shape) != (2, 1800, 26) or not finite or not err <= GENERATE_REL_TOL * scale:
        raise SystemExit("chip_smoke: generate on the kernel path is wrong")
    if min(counts[k] for k in SERVING_KERNELS) == 0:
        raise SystemExit(f"chip_smoke: a kernel of the path was never launched: {counts}")
    if counts["adaln_modulation"] != 50:
        raise SystemExit(f"chip_smoke: K1 did not launch its AdaLN GEMM on every step: {counts}")

    # 5. timings on the kernel path
    mel1, noise1 = mel[:1].contiguous(), noise[:1].contiguous()
    kernel_tr.generate(mel1, num_steps=50, noise=noise1)  # warm-up
    _, t50 = _timed(lambda: kernel_tr.generate(mel1, num_steps=50, noise=noise1))
    _, t50_plain = _timed(lambda: plain_tr.generate(mel1, num_steps=50, noise=noise1))
    print(f"[time] ddim50 one 60-s clip: kernel path {t50 * 1e3:.1f} ms, "
          f"plain path {t50_plain * 1e3:.1f} ms ({smi})")

    mel8 = mel.repeat(4, 1, 1)
    noise8 = torch.from_numpy(rng.normal(size=(8, 1800, 26)).astype(np.float32)).cuda()
    enc_ms = time_ms(lambda: kernel_tr.fused_encoder(mel8), 3)
    motion8, t1000 = _timed(lambda: kernel_tr.generate(mel8, noise=noise8))
    if not bool(torch.isfinite(motion8).all()):
        raise SystemExit("chip_smoke: the ddim1000 ladder gave non-finite motion")
    fps = 8 * 1800 / t1000
    print(f"[time] ddim1000 B=8: {t1000:.3f} s, {fps:.1f} motion frames/s "
          f"(encoder {enc_ms:.2f} ms of it) on {smi}")

    # 6. training: kernel path, then the plain path, same weights and numbers
    def train(tr, m_lens=None):
        """4 steps on the training batch: losses, `loss_mot_feat`s, seconds
        and launch counts, each step's own."""
        losses, feats, times, step_counts = [], [], [], []
        for d in drawn:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(mel_train, motion_train, m_lens, **d)
            losses.append(float(m["loss"]))  # host readback ends the step
            times.append(time.perf_counter() - t0)
            feats.append(float(m["loss_mot_feat"]))
            step_counts.append(launch_counts())
        return losses, feats, times, step_counts

    losses_k, feats_k, times_k, step_counts = train(kernel_tr)
    losses_p, feats_p, times_p, _ = train(plain_tr)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    rel_feat = [abs(a - b) / abs(b) for a, b in zip(feats_k, feats_p)]
    per_step = [{k: c[k] for k in TRAIN_KERNELS} for c in step_counts]
    train_counts = {k: sum(c[k] for c in per_step) for k in TRAIN_KERNELS}
    print(f"[train] B={n_train} T={t_train} losses kernel {losses_k} plain {losses_p} "
          f"max rel diff {max(rel):.3g} launches {dict((k, train_counts[k]) for k in TRAIN_KERNELS)}")
    print(f"[train] loss_mot_feat kernel {feats_k} plain {feats_p} max rel diff "
          f"{max(rel_feat):.3g}; launches per step {per_step}")
    print(f"[time] train step B={n_train} T={t_train}: kernel path median "
          f"{np.median(times_k) * 1e3:.1f} ms, plain path median {np.median(times_p) * 1e3:.1f} ms "
          f"(per step: kernel {[round(x * 1e3, 1) for x in times_k]}, plain "
          f"{[round(x * 1e3, 1) for x in times_p]}) on {smi}")
    if (not all(np.isfinite(losses_k + feats_k)) or max(rel) > TRAIN_LOSS_REL_TOL
            or max(rel_feat) > TRAIN_LOSS_REL_TOL):
        raise SystemExit("chip_smoke: training on the kernel path disagrees with the plain path")
    if min(c[k] for c in per_step for k in TRAIN_KERNELS) == 0 or any(
            (c["stgcn_forward"], c["stgcn_backward"]) != K7_PER_STEP for c in per_step):
        raise SystemExit(f"chip_smoke: a training kernel was not launched in every step: {per_step}")
    counts.update({k: train_counts[k] for k in TRAIN_KERNELS})

    # 7. stage 1: kernel path, then the plain path, same weights and starts
    def train_s1(tr):
        losses, times, step_counts = [], [], []
        for st in starts:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(music, motion_s1, "hard", starts=st)
            losses.append(float(m["loss"]))  # host readback ends the step
            times.append(time.perf_counter() - t0)
            step_counts.append({k: v for k, v in launch_counts().items() if k in STAGE1_KERNELS})
        return losses, times, step_counts

    m2s_plain.load_reference_state_dict(m2s_sd)
    losses_k1, times_k1, counts_s1 = train_s1(m2s_kernel)
    losses_p1, times_p1, _ = train_s1(m2s_plain)
    m2s_share = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, share_encodes=True,
                              device="cuda")
    m2s_share.load_reference_state_dict(m2s_sd)
    losses_s1, times_s1, _ = train_s1(m2s_share)
    rel1 = [abs(a - b) / abs(b) for a, b in zip(losses_k1, losses_p1)]
    print(f"[stage1] B={STAGE1_B} crops {STAGE1_C} s, hard, starts {starts}: losses kernel "
          f"{losses_k1} plain {losses_p1} max rel diff {max(rel1):.3g}; share_encodes kernel "
          f"losses {losses_s1}; launches per step {counts_s1}")
    print(f"[time] stage-1 step B={STAGE1_B}: kernel path median {np.median(times_k1) * 1e3:.1f} ms, "
          f"plain path median {np.median(times_p1) * 1e3:.1f} ms, share_encodes kernel path median "
          f"{np.median(times_s1) * 1e3:.1f} ms (per step: kernel "
          f"{[round(x * 1e3, 1) for x in times_k1]}, plain {[round(x * 1e3, 1) for x in times_p1]}, "
          f"share {[round(x * 1e3, 1) for x in times_s1]}) on {smi}")
    if not all(np.isfinite(losses_k1 + losses_s1)) or max(rel1) > TRAIN_LOSS_REL_TOL:
        raise SystemExit("chip_smoke: stage 1 on the kernel path disagrees with the plain path")
    if min(c[k] for c in counts_s1 for k in STAGE1_KERNELS) == 0 or any(
            c["max_pool"] != K10_PER_STEP for c in counts_s1):
        raise SystemExit(f"chip_smoke: a stage-1 kernel was not launched in every step: {counts_s1}")
    counts.update({k: sum(c[k] for c in counts_s1) for k in STAGE1_KERNELS if k != "conv_block"})

    # 8. training with the reference's loss mask: "auto" on CUDA, then the
    # plain float32 path with the mask, same weights, batch and numbers
    mask_cfg = cfg.replace(train=TrainConfig(replicate_reference_mask=True))
    mask_tr = DDPMTrainer(mask_cfg, device="cuda")
    md = mask_tr.cfg.denoiser
    if (md.compute_dtype, md.train_layer_impl, md.attention_impl, mask_tr.cfg.train.feat_impl) != (
            "bfloat16", "flax", "pallas", "pallas"):
        raise SystemExit(f"chip_smoke: 'auto' with the reference mask resolved to {md}")
    mask_plain = DDPMTrainer(mask_cfg.replace(
        denoiser=DenoiserConfig(layer_impl="flax", music_encoder_impl="flax",
                                train_layer_impl="flax", attention_impl="xla",
                                compute_dtype="float32"),
        train=TrainConfig(replicate_reference_mask=True, feat_impl="flax")), device="cuda")
    for tr in (mask_tr, mask_plain):
        tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    m_lens = torch.full((n_train,), REFERENCE_M_LENS)
    losses_m, feats_m, times_m, counts_m = train(mask_tr, m_lens)
    losses_mp, feats_mp, times_mp, _ = train(mask_plain, m_lens)
    rel_m = [abs(a - b) / abs(b) for a, b in zip(losses_m + feats_m, losses_mp + feats_mp)]
    mask_kernels = ("linear_attention", "stgcn_forward", "stgcn_backward")
    per_step_m = [{k: c[k] for k in mask_kernels} for c in counts_m]
    print(f"[mask] B={n_train} T={t_train} m_lens={REFERENCE_M_LENS}: losses kernel {losses_m} "
          f"plain {losses_mp}; loss_mot_feat kernel {feats_m} plain {feats_mp}; max rel diff "
          f"{max(rel_m):.3g}; launches per step {per_step_m}")
    print(f"[time] reference-mask train step B={n_train} T={t_train}: K8 path median "
          f"{np.median(times_m) * 1e3:.1f} ms, plain path median {np.median(times_mp) * 1e3:.1f} ms "
          f"(per step: K8 {[round(x * 1e3, 1) for x in times_m]}, plain "
          f"{[round(x * 1e3, 1) for x in times_mp]}) on {smi}")
    if not all(np.isfinite(losses_m + feats_m)) or max(rel_m) > TRAIN_LOSS_REL_TOL:
        raise SystemExit("chip_smoke: the reference-mask step disagrees with the plain path")
    if any(c["linear_attention"] != md.num_layers
           or (c["stgcn_forward"], c["stgcn_backward"]) != K7_PER_STEP for c in per_step_m):
        raise SystemExit(f"chip_smoke: K8 / K7 not launched as expected in every step: {per_step_m}")
    counts["linear_attention"] = sum(c["linear_attention"] for c in per_step_m)
    del mask_tr, mask_plain

    # 9. serving on the plain layers in bf16, K4 encoder and K8 attention
    flax_tr = DDPMTrainer(cfg.replace(denoiser=DenoiserConfig(layer_impl="flax")), device="cuda")
    fd = flax_tr.cfg.denoiser
    if (fd.compute_dtype, fd.attention_impl, fd.music_encoder_impl) != ("bfloat16", "pallas", "pallas"):
        raise SystemExit(f"chip_smoke: 'auto' with layer_impl='flax' resolved to {fd}")
    flax_tr.load_reference_state_dict(sd)
    reset_launch_counts()
    out_flax = flax_tr.generate(mel, num_steps=50, noise=noise)
    torch.cuda.synchronize()
    flax_counts = launch_counts()
    err_f = float((out_flax - ref).abs().max())
    print(f"[serve-flax] ddim50 B=2 bf16 plain layers: max_abs_err vs plain {err_f:.6g} (plain max "
          f"{scale:.6g}) launches {flax_counts}")
    if (tuple(out_flax.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_flax).all())
            or not err_f <= GENERATE_REL_TOL * scale):
        raise SystemExit("chip_smoke: generate on the bf16 plain layers is wrong")
    if flax_counts["linear_attention"] != fd.num_layers * 50 or flax_counts["conv_block"] == 0:
        raise SystemExit(f"chip_smoke: K8 / K4 not launched as expected in serving: {flax_counts}")
    _, t_flax = _timed(lambda: flax_tr.generate(mel, num_steps=50, noise=noise))
    print(f"[time] ddim50 B=2 on the bf16 plain layers (K4, K8): {t_flax * 1e3:.1f} ms on {smi}")

    # 10. serving under bench.py's exact config: int8 AdaLN (K2 int8 output,
    # K1 int8 mode), then with the bf16-VPU mode added; then bench.py's
    # headline, ddim1000 at B = 8, best of 3 timed to the host readback
    del flax_tr
    bench_cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, **BENCH_DENOISER))
    bench_counts = {}
    for label, vpu in (("bench", "float32"), ("bench+vpu_bf16", "bfloat16")):
        tr = DDPMTrainer(bench_cfg.replace(denoiser=dataclasses.replace(
            bench_cfg.denoiser, sampler_vpu_dtype=vpu)), device="cuda")
        tr.load_reference_state_dict(sd)
        reset_launch_counts()
        out_b = tr.generate(mel, num_steps=50, noise=noise)
        torch.cuda.synchronize()
        bc = launch_counts() | part_launch_counts()
        err_b = float((out_b - ref).abs().max())
        print(f"[serve-{label}] ddim50 B=2 int8 AdaLN, VPU {vpu}: max_abs_err vs plain float32 "
              f"{err_b:.6g} (plain max {scale:.6g}) launches {bc}")
        if (tuple(out_b.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_b).all())
                or not err_b <= GENERATE_REL_TOL * scale):
            raise SystemExit(f"chip_smoke: generate under bench.py's config ({label}) is wrong")
        modes = ["decoder_stack_int8", "sampler_prologue_int8"] + (
            ["decoder_stack_vpu_bf16"] if vpu == "bfloat16" else [])
        if (any(bc[k] != 50 for k in modes) or bc["sampler_epilogue"] != 50
                or bc["adaln_modulation"] != 50):
            raise SystemExit(f"chip_smoke: the {label} modes did not run on every step: {bc}")
        bench_counts[label] = bc
        if vpu == "float32":
            bench_tr = tr
    del tr
    for k in ("decoder_stack_int8", "sampler_prologue_int8"):
        counts[k] = bench_counts["bench"][k]
    counts["decoder_stack_vpu_bf16"] = bench_counts["bench+vpu_bf16"]["decoder_stack_vpu_bf16"]
    counts["adaln_modulation_int8"] = bench_counts["bench"]["adaln_modulation"]
    # bench.py's compile call, then best of 3 on each config in turns
    best = {}
    for name, tr in (("bench.py serving (int8 AdaLN)", bench_tr), ("bf16", kernel_tr)):
        tr.generate(mel8, noise=noise8)
        times = []
        for _ in range(3):
            motion8, dt = _timed(lambda: tr.generate(mel8, noise=noise8))
            times.append(dt)
        if not bool(torch.isfinite(motion8).all()):
            raise SystemExit(f"chip_smoke: the {name} ddim1000 ladder gave non-finite motion")
        best[name] = (8 * 1800 / min(times), times)
    (fps_q, times_q), (fps_b, times_b) = best.values()
    print(f"[bench] ddim1000_60s_clip_motion_frames_per_sec_per_chip {fps_q:.1f} "
          f"(config: bench.py serving (int8 AdaLN); B=8, best of 3: {times_q} s) against "
          f"{fps_b:.1f} on the bf16 config (best of 3: {times_b} s; phase 5's one call: "
          f"{fps:.1f}), on {smi}")

    # 11. M2SGAN: 4 WGAN-GP steps at B = 55 on each path, (a) "auto" (K4
    # frozen encoder, K7 bf16) beside the plain float32 path, (b) (a) with
    # the features and real SyncLoss latents cached, (c) the encoder
    # training on "auto" (bf16, K4's training modes, K9, K10, K11) beside
    # its bf16 witness on cuDNN and the float32 "lax" path; cuDNN
    # deterministic, so that (b) can repeat (a)
    del kernel_tr, plain_tr, bench_tr, tr, m2s_kernel, m2s_plain, m2s_share
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def gan_steps(tr, cond, latents=None):
        """4 steps on the GAN batch: each step's metrics, seconds and launch
        counts, and the peak memory of the 4."""
        metrics, times, step_counts = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for noise_i, alpha_i in gan_drawn:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(cond, gan_real, latents, noise=noise_i, gp_alpha=alpha_i)
            metrics.append({k: float(v) for k, v in m.items()})  # host readback ends the step
            times.append(time.perf_counter() - t0)
            step_counts.append({k: v for k, v in launch_counts().items() if k in GAN_KERNELS})
        return metrics, times, step_counts, torch.cuda.max_memory_allocated()

    plain_kw = dict(music_encoder_impl="flax", sync_encoder_impl="flax",
                    sync_encoder_dtype="float32", compute_dtype="float32", music_conv_impl="lax")
    # (c)'s witness: its precision (a bf16 generator and SyncLoss) without
    # the kernels (the encoder on cuDNN, the SyncLoss module in bf16)
    witness_kw = plain_kw | dict(sync_encoder_dtype="bfloat16", compute_dtype="bfloat16")
    gan.load_reference_state_dict(*gan_sd, m2snet=m2s_sd)  # undo the check's statistics
    gan_runs = {"a": gan_steps(gan, gan_mel), "a_plain": gan_steps(gan_trainer(**plain_kw), gan_mel)}
    cached = gan_trainer(cached_features=True, cached_sync_latents=True)
    with torch.no_grad():
        feats, latents = cached.music_features(gan_mel), cached.sync_latents(gan_real)
    gan_runs["b"] = gan_steps(cached, feats, latents)
    del gan, cached, feats, latents
    torch.cuda.empty_cache()
    trains = gan_trainer(train_music_encoder=True)
    if (trains.compute_dtype, trains.music_conv_impl) != ("bfloat16", "pallas_train"):
        raise SystemExit("chip_smoke: 'auto' with train_music_encoder did not select the kernels")
    gan_runs["c"] = gan_steps(trains, gan_mel)
    del trains
    torch.cuda.empty_cache()
    gan_runs["c_bf16"] = gan_steps(gan_trainer(train_music_encoder=True, **witness_kw), gan_mel)
    gan_runs["c_plain"] = gan_steps(gan_trainer(train_music_encoder=True, **plain_kw), gan_mel)
    torch.backends.cudnn.deterministic = deterministic
    for name, (metrics, times, step_counts, peak) in gan_runs.items():
        print(f"[gan] ({name}) B={GAN_B} S={GAN_S} critic_iters={GAN_ITERS}: metrics "
              f"{metrics}; launches per step {step_counts}")
        print(f"[time] m2sgan step ({name}) B={GAN_B}: median {np.median(times) * 1e3:.1f} ms (per "
              f"step {[round(x * 1e3, 1) for x in times]}), peak memory {peak} bytes on {smi}")
    # every step: finite metrics and loss_sync within 3e-2 of the plain
    # path's; the first step, from the same weights, batch and numbers on
    # both sides, w_distance and loss_adv within 0.05, the JAX tests' bound
    # for one step of these paths.  (a) against the plain float32 path, (c)
    # against its bf16 witness: a bf16 generator's output moves by its
    # rounding far more than the kernels' summation orders move it, so
    # (c) against float32 is printed, not bounded.  Later steps diverge as
    # GAN updates do, and are printed.
    gan_bad = []
    for path, ref in (("a", "a_plain"), ("c", "c_bf16")):
        for i, (got, want) in enumerate(zip(gan_runs[path][0], gan_runs[ref][0])):
            if (not all(np.isfinite(list(got.values()) + list(want.values())))
                    or abs(got["loss_sync"] - want["loss_sync"]) > TRAIN_LOSS_REL_TOL * abs(
                        want["loss_sync"])
                    or (i == 0 and any(abs(got[k] - want[k]) > GAN_ADV_TOL
                                       for k in ("w_distance", "loss_adv")))):
                gan_bad.append((path, i, got, want))
    for path, ref in (("a", "a_plain"), ("c", "c_bf16"), ("c", "c_plain"), ("c_bf16", "c_plain")):
        print(f"[gan] ({path}) against ({ref}) by step: "
              + "; ".join(f"w_distance {abs(g['w_distance'] - w['w_distance']):.6g}, loss_adv "
                          f"{abs(g['loss_adv'] - w['loss_adv']):.6g}, loss_sync rel "
                          f"{abs(g['loss_sync'] - w['loss_sync']) / abs(w['loss_sync']):.6g}"
                          for g, w in zip(gan_runs[path][0], gan_runs[ref][0])))
    if gan_bad:
        raise SystemExit(f"chip_smoke: the M2SGAN kernel paths disagree with the plain ones: {gan_bad}")
    if gan_runs["b"][0] != gan_runs["a"][0]:
        raise SystemExit("chip_smoke: the cached M2SGAN step did not repeat the uncached one bit "
                         "for bit")
    expect = {"a": lambda c: (c["conv_block"], c["stgcn_forward"], c["stgcn_backward"]) == (7, 2, 1),
              "b": lambda c: (c["conv_block"], c["stgcn_forward"], c["stgcn_backward"]) == (0, 1, 1),
              "c": lambda c: (min(c["conv_block"], c["conv3x3_dkernel"]) > 0
                              and (c["max_pool"], c["max_pool_bwd"]) == (6, 3)
                              and (c["stgcn_forward"], c["stgcn_backward"]) == (2, 1))}
    expect |= {path: lambda c: not any(c.values()) for path in ("a_plain", "c_bf16", "c_plain")}
    for path, ok in expect.items():
        if not all(ok(c) for c in gan_runs[path][2]):
            raise SystemExit(f"chip_smoke: M2SGAN path ({path}) did not launch its kernels as "
                             f"expected: {gan_runs[path][2]}")
    gan_counts = {k: sum(c[k] for path in "abc" for c in gan_runs[path][2]) for k in GAN_KERNELS}
    print(f"[gan] launches in phase 11's kernel paths (a), (b), (c): {gan_counts}")
    for k, n in gan_counts.items():
        counts[k] += n

    # 12. the stage-2 CLI on the card, beside phase 6's bare step
    for k, n in cli_phase(smi, float(np.median(times_k))).items():
        counts[k] += n

    kernels = []
    for r in results:
        if r["name"] not in KERNEL_SOURCES:  # K4's training modes and B = 8, reported above
            continue
        source, replaces = KERNEL_SOURCES[r["name"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[r["name"]], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        } | {k: r[k] for k in YARDSTICK_KEYS if k in r})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
