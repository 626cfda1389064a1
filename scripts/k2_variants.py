#!/usr/bin/env python3
"""K2's and K3's designs on the card, varied: build variants of
`conductor_tpu_torch/csrc/sampler_glue.cu` that change one tuning constant
(K2's ring stages and blocks an SM; K3's rows a group, warps a block,
blocks an SM and ring stages), put back the division that K2's int8 SiLU
replaced by `__frcp_rn`, or leave out a part of K3's work (its stores, its
x_t loads, 28 of the 32 steps of its chains: the outputs are then wrong),
each from a copy of the source under build/k2var/, and print each
variant's device ms a call (`kernel_checks.launch_split`, mean of 20 calls
back to back) of K2 (bf16 emb_act), K2 int8 and K3 at B = 2 and 8,
T = 1800 (bf16 operands, seeded inputs as `scripts/k2_k3_sampler.py`
makes them), with the largest distance of each output from the plain
version over its largest value and, for the int8 codes, the count that
differ from it.  It also prints each variant's registers and spills as
ptxas reports them.

    python3 scripts/k2_variants.py [--only NAME ...]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from conductor_tpu_torch import kernel_checks  # noqa: E402
from conductor_tpu_torch.ops import _build  # noqa: E402
from conductor_tpu_torch.ops.sampler_glue import (  # noqa: E402
    sampler_epilogue_plain,
    sampler_prologue_plain,
)

SRC = _build.CSRC
OUT = REPO / "build" / "k2var"
STAGES = "constexpr int kProStages = 2;"
BLOCKS = "constexpr int kProBlocksPerSm = 3;"
GROUP = "constexpr int kEpiGroup = 4;"
EPI_WARPS = "constexpr int kEpiWarps = 4;"
EPI_BLOCKS = "constexpr int kEpiBlocksPerSm = 2;"
EPI_STAGES = "constexpr int kEpiStages = 2;"
# name -> (old, new) text replacements in sampler_glue.cu
VARIANTS = {
    "base": [],
    "blocks2": [(BLOCKS, BLOCKS.replace("3", "2"))],
    "stages3_blocks2": [(STAGES, STAGES.replace("2", "3")), (BLOCKS, BLOCKS.replace("3", "2"))],
    "stages4_blocks2": [(STAGES, STAGES.replace("2", "4")), (BLOCKS, BLOCKS.replace("3", "2"))],
    "fdiv": [("__frcp_rn(__fadd_rn(1.f, expf(-v)))",
              "__fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)))")],
    "k3_group2": [(GROUP, GROUP.replace("4", "2"))],
    "k3_group8": [(GROUP, GROUP.replace("4", "8"))],
    "k3_warps2": [(EPI_WARPS, EPI_WARPS.replace("4", "2"))],
    "k3_blocks3": [(EPI_BLOCKS, EPI_BLOCKS.replace("2", "3"))],
    "k3_stages3": [(EPI_STAGES, EPI_STAGES.replace("2", "3"))],
    # K3 with a part of its work left out, to see what bounds it
    "k3_no_stores": [("if (j < nr && lane < C)\n        out[",
                      "if (j < nr && lane < C && acc[j] != acc[j])\n        out[")],
    "k3_no_x_t": [("xv[j] = __ldg(x_t + (size_t)(r0 + j) * C + lane);", "xv[j] = 0.f;")],
    "k3_d4_of_32": [("for (int d4 = 0; d4 < W / 4; ++d4) {",
                     "for (int d4 = 0; d4 < 4; ++d4) {")],
}
T, D, E, C = 1800, 128, 512, 26
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(names) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(SRC / "common.cuh", d)
        s = (SRC / "sampler_glue.cu").read_text()
        for a, b in VARIANTS[name]:
            assert a in s, (name, a)
            s = s.replace(a, b)
        (d / "sampler_glue.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "sampler_glue.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(name, "FAILED", log[-3000:], flush=True)
            continue
        regs = re.findall(r"entry function '\S*?(prologue_rows|epilogue_tiles)\S*'.*?(\d+) bytes "
                          r"spill stores.*?Used (\d+) registers", log, re.S)
        print(f"[build] {name}: " + "; ".join(f"{k} {r} registers, {sp} bytes spilled"
                                             for k, sp, r in regs), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.sampler_prologue_forward.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        lib.sampler_epilogue_forward.argtypes = [_P] * 5 + [_F, _F] + [_I] * 5 + [_P]
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"on {smi}", flush=True)
    libs = build(args.only)
    bf = torch.bfloat16
    rng = np.random.RandomState(0)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    temb, w_joint, seq_bias = rand(E), rand(C, D, scale=0.2), rand(T, D, scale=0.1)
    w_out, b_out = rand(D, C, scale=0.1), rand(C, scale=0.1)
    for b in (2, 8):
        x, emb_base, hin = rand(b, T, C), rand(b, T, E, scale=2.0), rand(b, T, D)
        pro = (x, temb, emb_base, w_joint, seq_bias)
        want = {False: sampler_prologue_plain(*pro, mxu_dtype=bf, emb_dtype=bf),
                True: sampler_prologue_plain(*pro, mxu_dtype=bf, quantize_emb=True)}
        want_epi = sampler_epilogue_plain(hin, x, w_out, b_out, 0.9, 0.1, mxu_dtype=bf)
        for name, lib in libs.items():
            row = []
            for q in (False, True):
                h = torch.empty(b, T, D, device="cuda")
                emb = torch.empty(b, T, E, device="cuda", dtype=torch.int8 if q else bf)
                scale = torch.empty(b, T, 1, device="cuda") if q else None

                def call():
                    err = lib.sampler_prologue_forward(
                        x.data_ptr(), temb.data_ptr(), emb_base.data_ptr(), w_joint.data_ptr(),
                        seq_bias.data_ptr(), h.data_ptr(), emb.data_ptr(),
                        scale.data_ptr() if q else None, b, T, C, D, E, 1, _build.stream())
                    _build.check(err, name)

                ms = sum(d for _, d in kernel_checks.launch_split(call, 20))
                wh, we, ws = want[q]
                errs = [float((h - wh).abs().max() / wh.abs().max())]
                if q:
                    differ = int((emb != we).sum())
                    errs.append(float((emb.float() * scale - we.float() * ws).abs().max()
                                      / (we.float() * ws).abs().max()))
                    row.append(f"K2 int8 {ms:.4f} (err {max(errs):.3g}, codes differing {differ})")
                else:
                    errs.append(float((emb.float() - we.float()).abs().max()
                                      / we.float().abs().max()))
                    row.append(f"K2 {ms:.4f} (err {max(errs):.3g})")
            out = torch.empty_like(x)

            def epi():
                err = lib.sampler_epilogue_forward(
                    hin.data_ptr(), x.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
                    out.data_ptr(), 0.9, 0.1, b, T, D, C, 1, _build.stream())
                _build.check(err, name)

            ms = sum(d for _, d in kernel_checks.launch_split(epi, 20))
            err = float((out - want_epi).abs().max() / want_epi.abs().max())
            row.append(f"K3 {ms:.4f} (err {err:.3g})")
            print(f"[variant] {name} B={b}: device ms " + "; ".join(row) + f" ({smi})", flush=True)


if __name__ == "__main__":
    main()
