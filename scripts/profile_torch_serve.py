#!/usr/bin/env python3
"""Where a serving call of the PyTorch port spends its time on a CUDA card.

    python3 scripts/profile_torch_serve.py [--tree DIR] [--batches 1 2 8]

`DDPMTrainer.generate(num_steps=10)` on the flagship configuration
(D = 128, 8 layers, E = 512) with synthetic weights, 60-s clips (mel
(B, 5400, 128), seeded), on three configs: bench.py's serving config
(int8 AdaLN, `bench.py:41-50`), the bf16 config ("auto" on CUDA) and
float32 on the fused ladder's float32 mode (``compute_dtype="float32"``,
``layer_impl="pallas_fused"``, the plain training layers).  Per config
and batch: one warm-up call, two calls timed to the host readback, then one
under `torch.profiler`.  It prints the wall ms per ladder step without and
under the profiler, the device ms per step (the kernels' summed times), the
card's idle share of the wall under the profiler, K1's device ms per step
split by launch (the AdaLN GEMM, pass A
`kv_partials`, pass B `kv_combine`, the row pass `layer_rows`; an earlier
K1 without the GEMM shows 0 there and the product inside its row pass),
K2's and K3's device ms per step, and the five kernels with the most
device time.  ``--tree`` profiles the
port in another checkout (a parent commit unpacked by `git archive`),
which builds its own kernels; a config that tree refuses at construction
(the float32 ladder before it was ported) is skipped, with a line saying so.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

STEPS = 10
# bench.py's serving config (bench.py:41-50), applied to the port's Config()
BENCH_DENOISER = dict(attention_impl="pallas", compute_dtype="bfloat16", layer_impl="pallas_fused",
                      sampler_adaln_int8=True, music_encoder_impl="pallas")
K1_PARTS = {"adaln_gemm": ("adaln_gemm",), "kv_partials": ("kv_partials",),
            "kv_combine": ("kv_combine",), "layer_rows": ("layer_rows",)}
# K2's and K3's kernels, by their names before and after their redesign
GLUE_PARTS = {"K2": ("prologue_kernel", "prologue_rows"),
              "K3": ("epilogue_kernel", "epilogue_tiles")}


def profile_call(call) -> dict:
    call()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        call().cpu()
    wall = (time.perf_counter() - t0) / 2
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call().cpu()
        wall_prof = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device = sum(by_name.values())
    split, glue = ({part: sum(ms for name, ms in by_name.items() if any(k in name for k in keys))
                    for part, keys in parts.items()} for parts in (K1_PARTS, GLUE_PARTS))
    return dict(wall=wall, wall_prof=wall_prof, device=device, split=split, glue=glue,
                by_name=by_name)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 8])
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.config import Config
    from conductor_tpu_torch.interop import synthetic_state_dict

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"tree {args.tree.resolve()} on {smi}")
    cfg = Config()
    configs = {
        "bench.py (int8 AdaLN)": cfg.replace(
            denoiser=dataclasses.replace(cfg.denoiser, **BENCH_DENOISER)),
        "bf16": cfg,
        "float32 fused ladder": cfg.replace(
            denoiser=dataclasses.replace(cfg.denoiser, compute_dtype="float32",
                                         layer_impl="pallas_fused", music_encoder_impl="pallas",
                                         train_layer_impl="flax"),
            train=dataclasses.replace(cfg.train, feat_impl="flax")),
    }
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(max(args.batches), 5400, 128))
                           .astype(np.float32)).cuda()
    sd = None
    for label, c in configs.items():
        try:
            tr = DDPMTrainer(c, device="cuda")
        except ValueError as e:
            print(f"[serve] {label}: skipped, the tree refuses it at construction: {e}")
            continue
        sd = sd or synthetic_state_dict(tr.model, seed=0)
        tr.load_reference_state_dict(sd)
        for b in args.batches:
            m = mel[:b].contiguous()
            r = profile_call(lambda: tr.generate(m, num_steps=STEPS))
            idle = 1 - r["device"] / (r["wall_prof"] * 1e3)
            split = ", ".join(f"{k} {v / STEPS:.4f}" for k, v in r["split"].items())
            top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:5]
            print(f"[serve] {label} B={b} ddim{STEPS}: wall {r['wall'] * 1e3 / STEPS:.3f} ms a "
                  f"step ({r['wall_prof'] * 1e3 / STEPS:.3f} under the profiler), device "
                  f"{r['device'] / STEPS:.3f} ms a step, idle {idle:.1%}; K1 device ms a step: "
                  f"{split}, K1 sum {sum(r['split'].values()) / STEPS:.4f}; K2 "
                  f"{r['glue']['K2'] / STEPS:.4f}, K3 {r['glue']['K3'] / STEPS:.4f}", flush=True)
            print("   top: " + "; ".join(f"{name[:60]} {ms / STEPS:.4f}" for name, ms in top))
        del tr


if __name__ == "__main__":
    main()
