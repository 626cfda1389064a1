#!/usr/bin/env python3
"""K7's design on the card, taken apart: build variants of
`conductor_tpu_torch/csrc/stgcn.cu` that change one constant or leave out
one part of the work, each from a copy of the source under build/k7var/,
and print each variant's device ms per forward and backward call (their
10 launches, `torch.profiler`, mean of 10 calls back to back) at the
stage-2 shape, B = 32, T = 900, on seeded random weights and inputs, with
the forward's distance from the first variant's output.  A variant that
leaves work out computes something else: its time says what that work
costs, not that it may go.

    python3 scripts/k7_variants.py [--only NAME ...]
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from conductor_tpu_torch.ops import _build  # noqa: E402

SRC = _build.CSRC
OUT = REPO / "build" / "k7var"
# name -> (old, new) text replacements in stgcn.cu
GEMM_A = "        tc::ldmatrix_x4(a, a_addr + (uint32_t)(((16 * m + (lane & 15)) * lda + k + (lane >> 4) * 8) * 2));"
GEMM_MMA = "        mma4(acc[m], a, lo, hi);\n      }\n    }\n    __syncwarp();  // every lane"
FWD_GEMM = "  warp_gemm<kFMT, false, kFDepth>(a_addr, kLdA, p.m + C * v, W, kFirst ? kInPad : W, region, acc);\n"
BWD_GEMM = "    warp_gemm<kBMT, true, kBDepth>(da_addr, kLdA, p.m + (size_t)C * v * W, W, W, region, acc);\n"
TCONVS = [("  tile_tconv<false>(region, taps, acc);\n", ""), ("    tile_tconv<true>(region, taps, acc);\n", "")]
VARIANTS = {
    "base": [],
    # the weight slabs' cp.async from L2 left out (the ring holds stale data)
    "no_stream": [("        tc::cp_async16(dst + sub(r, c), src + (size_t)r * ldb + 8 * c);\n", "")],
    # the products' A fragments not read from shared memory (a register value)
    "no_a_ldmatrix": [(GEMM_A, "        a[0] = a[1] = a[2] = a[3] = lane + k;")],
    # the graph-conv / projection products' MMAs left out (their loads stay)
    "no_gemm_mma": [(GEMM_MMA, GEMM_MMA.replace("mma4(acc[m], a, lo, hi);", ""))],
    # the temporal convs left out
    "no_tconv": TCONVS,
    # the graph-conv product (its stream, fragments and MMAs) left out
    "no_gemm": [(FWD_GEMM, ""), (BWD_GEMM, "")],
    # both: what is left is the loads, the epilogues, the stores and the launches
    "no_gemm_no_tconv": [(FWD_GEMM, ""), (BWD_GEMM, "")] + TCONVS,
}


def build(names) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in ("common.cuh", "tensor_core.cuh"):
            shutil.copy(SRC / h, d)
        s = (SRC / "stgcn.cu").read_text()
        for a, b in VARIANTS[name]:
            assert a in s, (name, a)
            s = s.replace(a, b)
        (d / "stgcn.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / "stgcn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(name, "FAILED", log[-3000:], flush=True)
            continue
        print(name, " | ".join(ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln),
              flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("stgcn_forward", "stgcn_backward"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = _build.SIGNATURES[fn]
        libs[name] = lib
    return libs


def device_ms(call, n: int = 10) -> float:
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ev if "stgcn" in e.name) / n / 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(args.only)
    g = torch.Generator(device="cuda").manual_seed(0)
    b, t, w = 32, 900, 416
    bf = torch.bfloat16

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype).contiguous()

    pack = [rand(32, w, scale=0.3, dtype=bf), rand(9, w, w, scale=w ** -0.5, dtype=bf),
            rand(10, 3, 32, 32, scale=0.1, dtype=bf), rand(10, w, scale=0.1), rand(10, 32, scale=0.1),
            rand(w, 64, scale=w ** -0.5, dtype=bf), rand(64, scale=0.1)]
    x = torch.rand((b, t, 13, 2), generator=g, device="cuda")
    dy = rand(b, t, 64)
    rows = b * t
    hbuf = torch.empty((2, rows, w), device="cuda")
    masks = torch.empty((2, 10, rows, 13), dtype=torch.int32, device="cuda")
    out = torch.empty((b, t, 64), device="cuda")
    dx = torch.empty((b, t, 13, 2), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ref = None
    for name, lib in libs.items():
        fwd_args = (x.data_ptr(), *(p.data_ptr() for p in pack), hbuf.data_ptr(),
                    masks[0].data_ptr(), masks[1].data_ptr(), out.data_ptr(), b, t, stream)
        bwd_args = (dy.data_ptr(), *(pack[i].data_ptr() for i in (0, 1, 2, 5)), masks[0].data_ptr(),
                    masks[1].data_ptr(), hbuf.data_ptr(), dx.data_ptr(), b, t, stream)
        fwd = lambda: lib.stgcn_forward(*fwd_args)  # noqa: E731
        bwd = lambda: lib.stgcn_backward(*bwd_args)  # noqa: E731
        assert fwd() == 0 and bwd() == 0
        torch.cuda.synchronize()
        ref = out.clone() if ref is None else ref
        err = float((out - ref).abs().max() / ref.abs().max())
        print(f"{name}: forward {device_ms(fwd):.4f} ms, backward {device_ms(bwd):.4f} ms device "
              f"(10 launches each; forward off the first variant's by {err:.2e})", flush=True)


if __name__ == "__main__":
    main()
