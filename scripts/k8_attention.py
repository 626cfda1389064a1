#!/usr/bin/env python3
"""K8's time on a CUDA card at its two paths' shapes.

    python3 scripts/k8_attention.py [--tree DIR] [--reps N]

K8 (`ops.attention.linear_attention_kernel`, 8 heads of 16, D = 128) on
seeded bf16 q, k and v with a key mask folded in as
`ops.attention.fused_linear_attention` folds it (a float32 mask makes k
and v float32): the reference-mask training step's shape, B = 32, T = 900,
m_lens = 60, and the plain-layer serving shape, B = 2, T = 1800, a ones
mask.  Per shape it prints the mean ms of a call by CUDA events, the
device ms of each launch (`kernel_checks.launch_split`), the byte bound
(`kernel_checks.bound`), the largest difference from the plain version
(`linear_attention_plain`, must be within 2 % of its largest value) and
whether a repeat is bit-identical.  ``--tree`` measures the port in
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

SHAPES = (("mask step", 32, 900, 60), ("serving", 2, 1800, 1800))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from conductor_tpu_torch import kernel_checks
    from conductor_tpu_torch.ops.attention import (
        fold_key_mask,
        linear_attention_kernel,
        linear_attention_plain,
    )

    if not torch.cuda.is_available():
        raise SystemExit("k8_attention: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"tree {args.tree.resolve()} on {smi}", flush=True)
    rng = np.random.RandomState(0)
    ok = True
    for label, b, t, lens in SHAPES:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, t, 128)).astype(np.float32)).cuda()
                   .to(torch.bfloat16) for _ in range(3))
        mask = (torch.arange(t, device="cuda")[None] < lens).float()[..., None].expand(b, t, 1)
        k, v = fold_key_mask(k, v, mask)
        call = lambda: linear_attention_kernel(q, k, v, 8)  # noqa: E731
        got, want = call(), linear_attention_plain(q, k, v, 8)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        repeat = torch.equal(got, call())
        ok &= err <= kernel_checks.REL_TOL * scale and repeat
        ms = kernel_checks.time_ms(call, args.reps)
        split = kernel_checks.launch_split(call, args.reps)
        bound = kernel_checks.bound((q, k, v), got, 0)["bound_ms"]
        print(f"[k8] {label} B={b} T={t}, q bf16, k and v {k.dtype}: {ms:.4f} ms a call; "
              f"device {sum(d for _, d in split):.4f} ms by launch: "
              + "; ".join(f"{name} {d:.4f}" for name, d in split)
              + f"; bound {bound:.4f} ms; err {err:.6g} (plain max {scale:.6g}); repeat "
              f"bit-identical {repeat} ({smi})", flush=True)
    if not ok:
        raise SystemExit("k8_attention: K8 disagrees with its plain version")


if __name__ == "__main__":
    main()
