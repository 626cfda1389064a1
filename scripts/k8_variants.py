#!/usr/bin/env python3
"""K8's design on the card, varied: build variants of
`conductor_tpu_torch/csrc/linear_attention.cu` that change one tuning
constant (a block's threads, the k / v rows staged at once) or run the
accurate `expf` and 16 divisions a q row in place of the SFU's `__expf`
and one reciprocal, each from a copy of the source under build/k8var/,
and print each variant's device ms a call (`torch.profiler`, mean of 20
calls back to back) at each cluster size the kernel takes
(`ops.attention.CLUSTERS`; the wrapper's `cluster_size` picks one) and
K8's two paths' shapes: the reference-mask step, B = 32, T = 900, and
plain-layer serving, B = 2, T = 1800 (bf16 q, float32 k and v with the key
mask folded in, as `kernel_checks.check_attention_kernel` makes them),
with the largest distance of an output from the plain version
(`linear_attention_plain`) over its largest value.

    python3 scripts/k8_variants.py [--only NAME ...] [--source FILE]

``--source`` builds the variants from another version of the file (an
earlier design, say) in place of the checkout's.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from conductor_tpu_torch.ops import _build  # noqa: E402
from conductor_tpu_torch.ops.attention import (  # noqa: E402
    CLUSTERS,
    fold_key_mask,
    linear_attention_plain,
)

SRC = _build.CSRC
OUT = REPO / "build" / "k8var"
THREADS = "constexpr int kThreads = 256;"
MIN_BLOCKS = "constexpr int kMinBlocks = 4;"
CHUNK = "constexpr int kChunk = 256;"
# name -> (old, new) text replacements in linear_attention.cu
VARIANTS = {
    "base": [],
    "threads128": [(THREADS, THREADS.replace("256", "128")),
                   (MIN_BLOCKS, MIN_BLOCKS.replace("4", "8"))],
    "chunk128": [(CHUNK, CHUNK.replace("256", "128"))],
    "accurate": [("__expf(", "expf("), ("x[d] * inv", "x[d] / sum")],
}
SHAPES = (("mask step", 32, 900, 60), ("serving", 2, 1800, 1800))


def build(names, source: Path) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(SRC / "common.cuh", d)
        s = source.read_text()
        for a, b in VARIANTS[name]:
            assert a in s, (name, a)
            s = s.replace(a, b)
        (d / "linear_attention.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "linear_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(name, "FAILED", log[-3000:], flush=True)
            continue
        print(name, " | ".join(ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = lib.linear_attention_forward
        fn.argtypes, fn.restype = _build.SIGNATURES["linear_attention_forward"]
        libs[name] = lib
    return libs


def device_ms(call, n: int = 20) -> float:
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ev if "attention" in e.name) / n / 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    ap.add_argument("--source", type=Path, default=SRC / "linear_attention.cu")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"source {args.source}", flush=True)
    libs = build(args.only, args.source)
    rng = np.random.RandomState(0)
    cases = []
    for label, b, t, lens in SHAPES:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, t, 128)).astype(np.float32)).cuda()
                   .to(torch.bfloat16) for _ in range(3))
        mask = (torch.arange(t, device="cuda")[None] < lens).float()[..., None].expand(b, t, 1)
        k, v = fold_key_mask(k, v, mask)
        cases.append((label, q, k, v, linear_attention_plain(q, k, v, 8).float()))
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        for label, q, k, v, want in cases:
            out = torch.empty_like(q)
            b, t, _ = q.shape
            line, err = [], 0.0
            for cluster in CLUSTERS:
                call = lambda: lib.linear_attention_forward(  # noqa: E731
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, t, 8, 16,
                    cluster, 1, 0, stream)
                assert call() == 0
                torch.cuda.synchronize()
                err = max(err, float((out.float() - want).abs().max() / want.abs().max()))
                line.append(f"S={cluster} {device_ms(call):.4f}")
            print(f"{name}, {label}: device ms " + ", ".join(line) + f" (err {err:.2e})",
                  flush=True)


if __name__ == "__main__":
    main()
