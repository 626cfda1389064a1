#!/usr/bin/env python3
"""K2 and K3, the sampler prologue and epilogue of every ladder step, on a
CUDA card at the serving shapes.

    python3 scripts/k2_k3_sampler.py [--tree DIR] [--reps N] [--batches 1 2 8]

`ops.sampler_glue.sampler_prologue` with bf16 emb_act (K2) and with int8
emb_act (K2 int8), and `sampler_epilogue` (K3), bf16 operands as in the
serving configs, on seeded inputs of a 60-s clip (T = 1800, D = 128,
E = 512, C = 26) at each batch.  Per kernel and batch it prints the mean
ms of a call by CUDA events (``--reps`` calls back to back), the device ms
of each launch (`kernel_checks.launch_split`), the bound
(`kernel_checks.bound`), the host µs a call of the public wrapper over
1,000 calls without a synchronise, where the tree has it of the launchers
`ops.sampler_glue.ladder_glue` hands the ladder (no checks), and of the C
entry point alone on outputs allocated once (its ctypes call and launch), the
largest difference from the plain version over its largest value (within
`kernel_checks.REL_TOL`; for the int8 codes, the count that differ) and
whether a repeat is bit-identical.  ``--tree`` measures the port in
another checkout (a parent commit unpacked by `git archive`), which builds
its own kernels; run the two trees in turns (parent, change, change,
parent) in one call to compare them.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T, D, E, C = 1800, 128, 512, 26
HOST_CALLS = 1000


def host_us(fn) -> float:
    """Host µs a call of ``fn`` over HOST_CALLS calls, unsynchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 8])
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from conductor_tpu_torch import kernel_checks
    from conductor_tpu_torch.ops import _build
    from conductor_tpu_torch.ops import sampler_glue as sg

    if not torch.cuda.is_available():
        raise SystemExit("k2_k3_sampler: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"tree {args.tree.resolve()} on {smi}", flush=True)
    bf = torch.bfloat16
    rng = np.random.RandomState(0)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    temb_table, w_joint, seq_bias = rand(1000, E), rand(C, D, scale=0.2), rand(T, D, scale=0.1)
    w_out, b_out = rand(D, C, scale=0.1), rand(C, scale=0.1)
    temb = temb_table[999]
    ok = True
    for b in args.batches:
        x, emb_base, h = rand(b, T, C), rand(b, T, E, scale=2.0), rand(b, T, D)
        pro = (x, temb, emb_base, w_joint, seq_bias)
        epi = (h, x, w_out, b_out, 0.9, 0.1)
        inner = {}
        if hasattr(sg, "ladder_glue"):
            for q in (False, True):
                p, e = sg.ladder_glue(x, temb_table, emb_base, w_joint, seq_bias, w_out, b_out,
                                      mxu_dtype=bf, quantize_emb=q)
                inner["K2 int8" if q else "K2"] = lambda p=p: p(x, temb)
                inner["K3"] = lambda e=e: e(h, x, 0.9, 0.1)
        # the C entry points alone, on outputs allocated once (both trees
        # export them with these arguments)
        lib, outs = _build.library(), {}
        for q in (False, True):
            outs[q] = (torch.empty(b, T, D, device="cuda"),
                       torch.empty(b, T, E, device="cuda", dtype=torch.int8 if q else bf),
                       torch.empty(b, T, 1, device="cuda") if q else None)
        bare = {
            ("K2 int8" if q else "K2"): (lambda q=q: lib.sampler_prologue_forward(
                *(a.data_ptr() for a in pro), *(o.data_ptr() for o in outs[q][:2]),
                outs[q][2].data_ptr() if q else None, b, T, C, D, E, 1, _build.stream()))
            for q in (False, True)}
        out_epi = torch.empty_like(x)
        bare["K3"] = lambda: lib.sampler_epilogue_forward(
            h.data_ptr(), x.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), out_epi.data_ptr(),
            0.9, 0.1, b, T, D, C, 1, _build.stream())
        calls = {
            "K2": (lambda: sg.sampler_prologue(*pro, mxu_dtype=bf, emb_dtype=bf),
                   lambda: sg.sampler_prologue_plain(*pro, mxu_dtype=bf, emb_dtype=bf), pro),
            "K2 int8": (lambda: sg.sampler_prologue(*pro, mxu_dtype=bf, quantize_emb=True),
                        lambda: sg.sampler_prologue_plain(*pro, mxu_dtype=bf, quantize_emb=True),
                        pro),
            "K3": (lambda: sg.sampler_epilogue(*epi, mxu_dtype=bf),
                   lambda: sg.sampler_epilogue_plain(*epi, mxu_dtype=bf), epi),
        }
        for name, (call, plain, inputs) in calls.items():
            got, want = call(), plain()
            if name == "K2 int8":  # h and the codes dequantized; the codes apart
                differ = int((got[1] != want[1]).sum())
                check = f"; int8 codes differing {differ} of {got[1].numel()}"
                got, want = (got[0], got[1].float() * got[2]), (want[0], want[1].float() * want[2])
            else:
                check = ""
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                    for g, w in pairs if w is not None]
            again = call()
            first = call()
            repeat = all(torch.equal(u, v) for u, v in zip(
                first if isinstance(first, tuple) else [first],
                again if isinstance(again, tuple) else [again]) if u is not None)
            ok &= max(errs) <= kernel_checks.REL_TOL and repeat
            ms = kernel_checks.time_ms(call, args.reps)
            split = kernel_checks.launch_split(call, 20)
            bound = kernel_checks.bound(inputs, call(), kernel_checks.flops(plain))
            host = f"host {host_us(call):.1f} us a call"
            if name in inner:
                host += f" (ladder_glue's launcher {host_us(inner[name]):.1f})"
            host += f", the C entry point alone {host_us(bare[name]):.1f}"
            print(f"[{name}] B={b} T={T}: {ms:.4f} ms a call by CUDA events; device "
                  f"{sum(d for _, d in split):.4f} ms in {len(split)} launch: "
                  + "; ".join(f"{n} {d:.4f}" for n, d in split)
                  + f"; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); {host}; err "
                  f"{max(errs):.3g} of the plain max{check}; repeat bit-identical {repeat} "
                  f"({smi})", flush=True)
    if not ok:
        raise SystemExit("k2_k3_sampler: a kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
