#!/usr/bin/env python3
"""K10's and K11's times on a CUDA card, pool by pool, at the stage-1 shapes.

    python3 scripts/k11_pools.py [--tree DIR] [--reps N] [--sweep]

The three pools of one stage-1 train-mode forward and backward at B = 10
with 10-s crops (`kernel_checks.stage1_kernel_inputs`, synthetic M2SNet
weights of seed 0, seeded music and motion): each pool's input x and
cotangent dy as the step hands them to the kernels.

K10 first (`ops.max_pool.fused_max_pool` on x): per pool the mean ms of a
call by CUDA events, the device ms of each launch, the byte bound, the
tiling (`ops.max_pool.fwd_plan`, where the tree has it), whether the
output equals the plain version's bit for bit and a repeat the first
call's, and `F.max_pool2d` on the same x in an NCHW view (the same
function, a library yardstick); then the sums.

Then K11 (`ops.max_pool.max_pool_bwd` on x and dy).  Per pool it prints
the shape, the mean ms of a call by CUDA events, the device ms of each
launch (`kernel_checks.launch_split`), the byte bound
(`kernel_checks.bound`), the tiling (`ops.max_pool.bwd_plan`, where the tree
has it), and the largest difference from the plain version
(`max_pool_bwd_plain`) on these inputs, on tied inputs (post-ReLU plateaus
rounded to a coarse grid, a quarter-integer cotangent: must be 0) and
between two calls (must be 0); then the sums.  One reference line a pool,
where the tree has it: autograd's `max_pool2d` backward on the same x and
dy in an NCHW view, its indices made outside the timed call
(`kernel_checks._reference_pool_bwd`).  It breaks ties its own way, so it
computes another function and is no yardstick.  ``--sweep`` also times K11
at other rows a tile (`ops.max_pool._bwd_launch`).  ``--tree`` measures
the port in another checkout (a parent commit unpacked by `git archive`),
which builds its own kernels.
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
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from conductor_tpu_torch import M2SNetTrainer, kernel_checks
    from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
    from conductor_tpu_torch.ops import max_pool

    if not torch.cuda.is_available():
        raise SystemExit("k11_pools: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"tree {args.tree.resolve()} on {smi}", flush=True)
    reps = args.reps
    plan = getattr(max_pool, "bwd_plan", None)
    reference = getattr(kernel_checks, "_reference_pool_bwd", None)

    m2s = M2SNetTrainer(sample_length=30, clip_length=10, device="cuda")
    m2s.load_reference_state_dict(synthetic_m2snet_state_dict(m2s.model, seed=0))
    rng = np.random.RandomState(0)
    music = torch.from_numpy(rng.uniform(0, 1, size=(10, 2700, 128)).astype(np.float32)).cuda()
    motion = torch.from_numpy(rng.uniform(0, 1, size=(10, 900, 13, 2)).astype(np.float32)).cuda()
    _, pools = kernel_checks.stage1_kernel_inputs(m2s, music, motion, (0, 300))
    gen = torch.Generator(device="cuda").manual_seed(0)
    fplan = getattr(max_pool, "fwd_plan", None)
    total, ok = [], True
    print(f"[k10] B=10, 10-s crops, the 3 pools of one forward ({smi})")
    for x, _, pool in reversed(pools):  # forward order
        call = lambda: max_pool.fused_max_pool(x, pool)  # noqa: E731
        got = call()
        exact = torch.equal(got, max_pool.max_pool_plain(x, pool))
        repeat = torch.equal(got, call())
        ok &= exact and repeat
        ms = kernel_checks.time_ms(call, reps)
        split = kernel_checks.launch_split(call, reps)
        bound = kernel_checks.bound(x, got, 0)["bound_ms"]
        (wt, wf), strides, ((pt, _), (pf, _)) = pool
        nchw = x.permute(0, 3, 1, 2)
        lib = lambda: torch.nn.functional.max_pool2d(nchw, (wt, wf), strides, (pt, pf))  # noqa: E731
        tiling = "" if fplan is None else "; plan " + str(
            {k: v for k, v in fplan(tuple(x.shape), pool).items()
             if k not in ("row_tiles", "col_chunks")})
        print(f"  pool {pool} x {list(x.shape)}: {ms:.4f} ms a call; device by launch: "
              + "; ".join(f"{name} {d:.4f}" for name, d in split)
              + f"; bound {bound:.4f} ms; equal to the plain version {exact}; repeat "
              f"bit-identical {repeat}; F.max_pool2d {kernel_checks.time_ms(lib, reps):.4f} ms, "
              f"device {kernel_checks.device_ms(lib, reps):.4f} ms{tiling}", flush=True)
        total.append((ms, sum(d for _, d in split), bound))
    print(f"  sum of 3: {sum(t[0] for t in total):.4f} ms, device {sum(t[1] for t in total):.4f} "
          f"ms, bound {sum(t[2] for t in total):.4f} ms", flush=True)
    total = []
    print(f"[k11] B=10, 10-s crops, the 3 pools of one forward and backward ({smi})")
    for x, dy, pool in reversed(pools):  # forward order
        call = lambda: max_pool.max_pool_bwd(x, dy, pool)  # noqa: E731
        got, want = call(), max_pool.max_pool_bwd_plain(x, dy, pool)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        repeat = torch.equal(got, call())
        tied = (torch.relu(x.float()) * 2).round().div(2).to(x.dtype)
        dy_q = (torch.randint(-8, 9, dy.shape, generator=gen, device="cuda") / 4).to(dy.dtype)
        tg = max_pool.max_pool_bwd(tied, dy_q, pool)
        tie_err = float((tg.float() - max_pool.max_pool_bwd_plain(tied, dy_q, pool).float())
                        .abs().max())
        conserved = float(tg.float().sum()) == float(dy_q.float().sum())
        good = err <= kernel_checks.REL_TOL * scale and repeat and tie_err == 0 and conserved
        ok &= good
        ms = kernel_checks.time_ms(call, reps)
        split = kernel_checks.launch_split(call, reps)
        bound = kernel_checks.bound((x, dy), got, 0)["bound_ms"]
        tiling = "" if plan is None else "; plan " + str(
            {k: v for k, v in plan(tuple(x.shape), pool).items()
             if k not in ("row_tiles", "col_chunks")})
        print(f"  pool {pool} x {list(x.shape)}: {ms:.4f} ms a call; device by launch: "
              + "; ".join(f"{name} {d:.4f}" for name, d in split)
              + f"; bound {bound:.4f} ms; err {err:.6g} (plain max {scale:.6g}); tied err "
              f"{tie_err:.6g}, sum dx == sum dy {conserved}; repeat bit-identical {repeat}"
              f"{tiling}", flush=True)
        if reference is not None:
            ref = reference(x, dy, pool)
            print(f"  reference, autograd's max_pool2d backward on the same x and dy (NCHW "
                  f"view, indices made outside the timed call; another tie rule, no "
                  f"yardstick): {kernel_checks.time_ms(ref, reps):.4f} ms, device "
                  f"{kernel_checks.device_ms(ref, reps):.4f} ms", flush=True)
        if args.sweep and plan is not None:
            for rows in (3, 6, 9, 12, 18, 24, 30, 36, 48, 60):
                if rows % pool[1][0]:
                    continue
                p = plan(tuple(x.shape), pool, rows=rows)
                sweep = lambda: max_pool._bwd_launch(  # noqa: E731
                    x, dy, max_pool._bwd_geometry(x, pool), rows, p["cols"], p["threads"])
                same = torch.equal(sweep(), got)
                print(f"    rows {rows}: {kernel_checks.time_ms(sweep, reps):.4f} ms, device "
                      f"{sum(d for _, d in kernel_checks.launch_split(sweep, reps)):.4f} ms, "
                      f"{p['blocks']} blocks, same bits {same}", flush=True)
        total.append((ms, sum(d for _, d in split), bound))
    print(f"  sum of 3: {sum(t[0] for t in total):.4f} ms, device {sum(t[1] for t in total):.4f} "
          f"ms, bound {sum(t[2] for t in total):.4f} ms; checks {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        raise SystemExit("k11_pools: K10 or K11 disagrees with its plain version")


if __name__ == "__main__":
    main()
