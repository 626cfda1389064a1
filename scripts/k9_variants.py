#!/usr/bin/env python3
"""K9's tuning constants on the card: build variants of
`conductor_tpu_torch/csrc/conv_train.cu` with other constants (tile budget
and blocks an SM, blocks' least tile count, ring depth, tile rows), each
from a copy of the source under build/k9var/, and print each variant's
device time per call (its two kernels, `torch.profiler`, mean of 20 calls
back to back) at the five stage-1 shapes (B = 10), its distance from the
first variant's result, and the sum over one stage-1 forward's seven calls.

    python3 scripts/k9_variants.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "conductor_tpu_torch" / "csrc"
OUT = REPO / "build" / "k9var"
NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
# name -> (old, new) text replacements in conv_train.cu
VARIANTS = {
    "base": [],
    "1blk_big": [("kSmemBudget = 110 * 1024", "kSmemBudget = 220 * 1024"),
                 ("kMaxBlocks = 2 * 132", "kMaxBlocks = 132"),
                 ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    "min8": [("kMinTiles = 4;", "kMinTiles = 8;")],
    "min2": [("kMinTiles = 4;", "kMinTiles = 2;")],
    "4stage": [("{{3, kSmemBudget}", "{{4, kSmemBudget}"),
               ("    if (p.stages == 3)\n",
                "    if (p.stages == 4)\n      cp_async_wait<3>();\n    else if (p.stages == 3)\n")],
    "rows32": [("kMaxTileRows = 16", "kMaxTileRows = 32"),
               ("kSmemBudget = 110 * 1024", "kSmemBudget = 113 * 1024")],
}
# (B, T, F, Cin, Cout) of the encoder's convs; blocks 2-3 and 6-7 run twice
SHAPES = [(10, 900, 128, 1, 16), (10, 900, 128, 16, 16), (10, 900, 64, 16, 32),
          (10, 900, 64, 32, 32), (10, 300, 32, 32, 32)]
TWICE = {(10, 900, 128, 16, 16), (10, 300, 32, 32, 32)}


def build() -> dict[str, ctypes.CDLL]:
    procs = {}
    for name, reps in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(SRC / "common.cuh", d)
        s = (SRC / "conv_train.cu").read_text()
        for a, b in reps:
            assert a in s, (name, a)
            s = s.replace(a, b)
        (d / "conv_train.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"), str(d / "conv_train.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(name, "FAILED", log[-3000:])
            continue
        print(name, " | ".join(ln.strip() for ln in log.splitlines() if "registers" in ln))
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.conv3x3_dkernel_workspace.argtypes = [ctypes.c_int] * 5
        lib.conv3x3_dkernel_workspace.restype = ctypes.c_longlong
        lib.conv3x3_dkernel.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.conv3x3_dkernel.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(call, n: int = 20) -> tuple[float, float]:
    """Device ms per call of the partial and the reduce kernel."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return tuple(sum(e.time_range.elapsed_us() for e in ev if key in e.name) / n / 1e3
                 for key in ("partial", "reduce"))


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = {n: 0.0 for n in libs}
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        b, t, f, ci, co = shape
        x = torch.randn(b, t, f, ci, generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn(b, t, f, co, generator=g, device="cuda").to(torch.bfloat16)
        ref, line = None, []
        for name, lib in libs.items():
            ws = torch.empty(lib.conv3x3_dkernel_workspace(*shape), dtype=torch.uint8, device="cuda")
            dw = torch.empty(3, 3, ci, co, device="cuda")
            args = (x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dw.data_ptr(), *shape, stream)
            call = lambda: lib.conv3x3_dkernel(*args)  # noqa: E731
            assert call() == 0
            torch.cuda.synchronize()
            ref = dw.clone() if ref is None else ref
            err = float((dw - ref).abs().max() / ref.abs().max())
            part, red = device_ms(call)
            totals[name] += (2 if shape in TWICE else 1) * (part + red)
            line.append(f"{name} {part:.4f}+{red:.4f} (err {err:.1e})")
        print(shape, "; ".join(line))
    print("seven calls:", {k: round(v, 4) for k, v in totals.items()})


if __name__ == "__main__":
    main()
