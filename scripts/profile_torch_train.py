#!/usr/bin/env python3
"""Where a stage-2 training step of the PyTorch port spends its time on a
CUDA card.

    python3 scripts/profile_torch_train.py [--impl pallas_fused|flax] [--feat auto|flax|pallas]
                                           [--cached]

Flagship configuration (D = 128, 8 layers, E = 512) on synthetic weights,
B = 32 windows of 30 s (T = 900 motion / 2700 mel frames), seeded data; with
``--cached`` the batch carries frozen-encoder features instead of mel
(``TrainConfig.cached_features``), so the music encoder drops out.
``--feat`` picks the perceptual ST-GCN: "auto" is K7 on the kernel path,
"flax" the plain float32 module.  After two warm-up steps it times two
steps, then `torch.profiler` records two more; the script prints the wall
time per step without and under the profiler, the device time per step (the
sum of the kernels' times), the device's busy share of the wall time under
the profiler, the perceptual term alone (its latents of pred and target and
its backward to pred, CUDA events, on pred and target of a training
forward), and the kernels by total device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
STEPS = 2  # profiled steps, after two warm-up steps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="pallas_fused", choices=["pallas_fused", "flax"])
    ap.add_argument("--feat", default="auto", choices=["auto", "flax", "pallas"])
    ap.add_argument("--cached", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    import sys

    sys.path.insert(0, str(REPO))
    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.config import Config, DenoiserConfig
    from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
    from conductor_tpu_torch.kernel_checks import perceptual_inputs, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, cached_features=args.cached,
                                                feat_impl=args.feat))
    if args.impl == "flax":
        cfg = cfg.replace(denoiser=DenoiserConfig(train_layer_impl="flax", compute_dtype="float32"),
                          train=dataclasses.replace(cfg.train, feat_impl="flax"))
    tr = DDPMTrainer(cfg, device="cuda")
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=0),
                                 motion_encoder=synthetic_motion_encoder_state_dict(tr.feat_model))
    rng = np.random.RandomState(0)
    b, n = cfg.train.batch_size, cfg.train.sample_length * cfg.dataset.motion_hz
    mel = torch.from_numpy(rng.uniform(0, 1, size=(b, 3 * n, 128)).astype(np.float32)).cuda()
    if args.cached:
        with torch.no_grad():
            mel = tr.model.music_encoder(mel)
    motion = torch.from_numpy(rng.uniform(0, 1, size=(b, n, 13, 2)).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        return float(tr.train_step(mel, motion, generator=gen)["loss"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS
    # device time: the kernels themselves (the CPU-side ops that launched
    # them carry the same time again)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / STEPS
    pred, target, _ = perceptual_inputs(tr, mel, motion)

    def perceptual():
        x = pred.detach().requires_grad_(True)
        tr.perceptual_loss(x, target).backward()

    feat_ms = time_ms(perceptual, 5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    lines = [f"train step, impl {args.impl}, feat_impl {tr.cfg.train.feat_impl}, "
             f"cached_features {args.cached}, B={b} T={n}, "
             f"{STEPS} steps profiled on {smi}",
             f"wall {wall_plain * 1e3:.2f} ms/step without the profiler, {wall * 1e3:.2f} ms/step "
             f"under it; device {device:.2f} ms/step, busy {100 * device / (wall * 1e3):.1f} % of "
             f"the wall under the profiler; perceptual term {feat_ms:.2f} ms (CUDA events)",
             prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30)]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
