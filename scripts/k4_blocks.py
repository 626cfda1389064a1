#!/usr/bin/env python3
"""K4's time on a CUDA card, call by call, at the shapes of its main paths.

    python3 scripts/k4_blocks.py [--tree DIR] [--reps N]

Serving: the 7 blocks of `FusedMusicEncoder` (flagship `Config()`,
synthetic weights of seed 0) on a seeded mel of 60-s clips (T = 5400,
F = 128) at B = 2 and B = 8, each block on the output of the one before.
Training: the 13 calls of one stage-1 train-mode forward and backward at
B = 10 with 10-s crops (`kernel_checks.stage1_kernel_inputs`): each 3x3
conv's forward (relu off, reflect edge) and, but for the first block's,
the zero-edge interior of its transposed conv.  A pooled serving block is
also timed as its conv alone followed by K10's pool pass
(`fused_max_pool`) on the conv's output.  Per call it prints the mean ms
of a call by CUDA events, the device ms of each launch
(`kernel_checks.launch_split`: the conv and pool launches apart where a
call makes two), the tiling the kernel picked
(`ops.conv_block.kernel_plan`, where the tree has it), and for the
training calls cuDNN's time on the same operands, `F.conv2d` in bf16 channels_last
(`kernel_checks._library_conv`, where the tree has it), by CUDA events
and in device time; then the sums.  ``--tree`` measures the port in
another checkout (a parent commit unpacked by `git archive`), which
builds its own kernels.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from conductor_tpu_torch import DDPMTrainer, M2SNetTrainer, kernel_checks
    from conductor_tpu_torch.config import Config
    from conductor_tpu_torch.interop import synthetic_m2snet_state_dict, synthetic_state_dict
    from conductor_tpu_torch.ops import conv_block, fused_conv_block, fused_max_pool

    if not torch.cuda.is_available():
        raise SystemExit("k4_blocks: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"tree {args.tree.resolve()} on {smi}", flush=True)
    reps = args.reps
    library = getattr(kernel_checks, "_library_conv", None)
    kernel_plan = getattr(conv_block, "kernel_plan", None)

    def measure(label, call, lib=None, plan=None):
        ms = kernel_checks.time_ms(call, reps)
        split = kernel_checks.launch_split(call, reps)
        lib_ms = None if lib is None else kernel_checks.time_ms(lib, reps)
        text = "none" if lib_ms is None else (
            f"{lib_ms:.4f} (device {kernel_checks.device_ms(lib, reps):.4f})")
        tiling = ("" if plan is None or kernel_plan is None
                  else f"; plan {kernel_plan(plan[0], plan[1], **plan[2])}")
        print(f"  {label}: {ms:.4f} ms a call; device by launch: "
              + "; ".join(f"{name} {d:.4f}" for name, d in split)
              + f"; cuDNN F.conv2d {text}{tiling}", flush=True)
        return ms, sum(d for _, d in split), lib_ms

    tr = DDPMTrainer(Config(), device="cuda")
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=0))
    enc = tr.fused_encoder
    rng = np.random.RandomState(0)
    for b in (2, 8):
        x = torch.from_numpy(rng.uniform(0, 1, size=(b, 5400, 128)).astype(np.float32)).cuda()
        x = x.to(torch.bfloat16)[..., None]
        total = []
        print(f"[k4-serve] B={b}, T=5400 ({smi})")
        for i, kw in enumerate(enc.block_args):
            call = lambda: fused_conv_block(x, mxu_dtype=torch.bfloat16, **kw)  # noqa: E731
            pool = "" if kw["pool"] is None else f", pool {kw['pool']}"
            total.append(measure(f"block {i} x {list(x.shape)} res {kw['res_mode']}{pool}", call,
                                 plan=(x.shape, kw["kernel"].shape[-1], dict(
                                     res_mode=kw["res_mode"], pool=kw["pool"]))))
            if kw["pool"] is not None:  # the same block as a conv launch, then K10's pool pass
                conv = dict(kw, pool=None)
                measure("  as conv + K10 pool pass", lambda: fused_max_pool(
                    fused_conv_block(x, mxu_dtype=torch.bfloat16, **conv), kw["pool"]))
            x = call()
        print(f"  sum of 7: {sum(t[0] for t in total):.4f} ms, device "
              f"{sum(t[1] for t in total):.4f} ms", flush=True)
        del x

    m2s = M2SNetTrainer(sample_length=30, clip_length=10, device="cuda")
    m2s.load_reference_state_dict(synthetic_m2snet_state_dict(m2s.model, seed=0))
    music = torch.from_numpy(rng.uniform(0, 1, size=(10, 2700, 128)).astype(np.float32)).cuda()
    motion = torch.from_numpy(rng.uniform(0, 1, size=(10, 900, 13, 2)).astype(np.float32)).cuda()
    convs, _ = kernel_checks.stage1_kernel_inputs(m2s, music, motion, (0, 300))
    total = []
    print(f"[k4-train] B=10, 10-s crops, the 13 calls of one forward and backward ({smi})")
    for x, kernel, dy in reversed(convs):  # forward order
        cout, cin = kernel.shape[-1], kernel.shape[2]
        one = torch.ones(cout, device="cuda")
        fwd = (x, kernel, one, torch.zeros_like(one))
        total.append(measure(
            f"forward x {list(x.shape)} -> {cout}", lambda: fused_conv_block(*fwd, relu=False),
            library and library(x, kernel, "reflect"), (x.shape, cout, {})))
        if cin > 1:
            wflip = kernel.flip(0, 1).transpose(2, 3).contiguous()
            one = torch.ones(cin, device="cuda")
            bwd = (dy, wflip, one, torch.zeros_like(one))
            total.append(measure(
                f"d(input) dy {list(dy.shape)} -> {cin}",
                lambda: fused_conv_block(*bwd, relu=False, edge="zero"),
                library and library(dy, wflip, "zero"), (dy.shape, cin, {})))
    lib = [t[2] for t in total]
    print(f"  sum of {len(total)}: {sum(t[0] for t in total):.4f} ms, device "
          f"{sum(t[1] for t in total):.4f} ms, cuDNN "
          f"{'none' if None in lib else f'{sum(lib):.4f} ms'}", flush=True)


if __name__ == "__main__":
    main()
