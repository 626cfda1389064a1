"""Build and load the port's CUDA kernels.

Every `conductor_tpu_torch/csrc/*.cu` is compiled by ``nvcc`` for sm_90a,
one ``nvcc`` process per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, at first use, under
``build/conductor_tpu_torch/`` in the checkout.  The decoder-layer sources
(`WIDTH_SOURCES`) are compiled once per model width in `WIDTHS`
(``-DLAYER_D=<D>``, one process each, all in parallel): their C entry
points carry the width in their names (``decoder_stack_forward_d64``), and
`width_entry` picks one.  The file name carries a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.  It is loaded with `ctypes`; every pointer and the
stream travel as ``c_void_p``.  Each C entry point launches on the stream it
is given and returns ``cudaGetLastError()``, which `check` turns into an
exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "conductor_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the model widths D the decoder kernels (K1, K5, K6, and K2 / K3 beside
# them) are built for, and the sources compiled once per width
WIDTHS = (32, 64, 128)
WIDTH_SOURCES = ("decoder_stack.cu", "decoder_layer_bwd.cu")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (argument types, return type)
SIGNATURES = {
    # x, w, scale, bias, resw, rscale, rbias, out (pooled if wt > 0),
    # B, T, F, Cin, Cout, res_mode, relu, zero_edge, wt, wf, st, sf, pt, pf, To, Fo, stream
    "conv_block_forward": ([_P] * 8 + [_I] * 16 + [_P], _I),
    # B, T, F, Cin, Cout, res_mode, wt, wf, st, sf, pt, pf, To, Fo, out (7 int32)
    "conv_block_plan": ([_I] * 14 + [_P], _I),
    # conv_block_forward's float32 mode, the same arguments
    "conv_block_forward_f32": ([_P] * 8 + [_I] * 16 + [_P], _I),
    # x, out, B, T, F, C, To, Fo, wt, wf, st, sf, pt, pf, rows, cols, threads, f32, stream
    "max_pool_forward": ([_P] * 2 + [_I] * 16 + [_P], _I),
    # B, T, F, C, To, Fo, wt, wf, st, sf, pt, pf, rows, cols, threads, f32, out, cap -> 0
    "max_pool_fwd_plan": ([_I] * 16 + [_P, _I], _I),
    # x, dy, dx, B, T, F, C, To, Fo, wt, wf, st, sf, pt, pf, rows, cols, threads, f32, stream
    "max_pool_backward": ([_P] * 3 + [_I] * 16 + [_P], _I),
    # B, T, F, Cin, Cout -> workspace bytes of conv3x3_dkernel
    "conv3x3_dkernel_workspace": ([_I] * 5, ctypes.c_longlong),
    # x, dy, workspace, dw, B, T, F, Cin, Cout, stream
    "conv3x3_dkernel": ([_P] * 4 + [_I] * 5 + [_P], _I),
    # the float32 mode of the two above, the same arguments
    "conv3x3_dkernel_f32_workspace": ([_I] * 5, ctypes.c_longlong),
    "conv3x3_dkernel_f32": ([_P] * 4 + [_I] * 5 + [_P], _I),
    # x, temb, emb_base, w_joint, seq_bias, h, emb_act, emb_scale (null: bf16
    # or float32 emb_act), B, T, C, D, E, round_bf16, emb_f32, stream
    "sampler_prologue_forward": ([_P] * 8 + [_I] * 7 + [_P], _I),
    # h, x_t, w_out, b_out, out, alpha, beta, B, T, D, C, round_bf16, stream
    "sampler_epilogue_forward": ([_P] * 5 + [_F, _F] + [_I] * 5 + [_P], _I),
    # B, T, C, D, E, which (0 K2, 1 K3), out (5 int32: rows, blocks, threads,
    # stages, shared bytes) -> 0
    "sampler_plan": ([_I] * 6 + [_P], _I),
    # emb, adaln_w, emb_scale, adaln_w_scale, adaln_b, out, launches, M, E, N, L,
    # operands (0 bf16, 1 int8, 2 float32), stream
    "adaln_modulation_forward": ([_P] * 7 + [_I] * 5 + [_P], _I),
    # M, N, L, operands, out (6 int32: BM, BN, threads, grid x, grid y,
    # dynamic shared bytes) -> 0
    "adaln_gemm_plan": ([_I] * 4 + [_P], _I),
    # x, m0, m, wt, b1, b2, fc, fcb, hbuf, gmask (null: no save), hmask, out, B, T, stream
    "stgcn_forward": ([_P] * 12 + [_I] * 2 + [_P], _I),
    # dy, m0, m, wt, fc, gmask, hmask, dh, dx, B, T, stream
    "stgcn_backward": ([_P] * 9 + [_I] * 2 + [_P], _I),
    # float32 mode: x, m0, m, wt, b1, b2, fc, fcb, h, g, gmask (null: no save),
    # hmask, out, B, T, stream
    "stgcn_forward_f32": ([_P] * 13 + [_I] * 2 + [_P], _I),
    # float32 mode: dy, m0, m, wt, fc, gmask, hmask, dh, da, dx, B, T, stream
    "stgcn_backward_f32": ([_P] * 10 + [_I] * 2 + [_P], _I),
    # B, T, backward, out (5 int32) -> 0
    "stgcn_plan": ([_I] * 3 + [_P], _I),
    # q, k, v, out, B, Tq, Tk, H, dh, cluster, q_bf16, kv_bf16, stream
    "linear_attention_forward": ([_P] * 4 + [_I] * 8 + [_P], _I),
    # dh, q_bf16, kv_bf16, out (5 int32: threads, dynamic and static shared
    # bytes, k / v rows a chunk, blocks an SM) -> 0, or -1 for another dh
    "linear_attention_plan": ([_I] * 3 + [_P], _I),
}
# the entry points of the WIDTH_SOURCES, each once per width as <name>_d<D>
WIDTH_SIGNATURES = {
    # x, emb, emb_scale, kv_cross, mats, vecs, adaln_w, adaln_w_scale, adaln_b,
    # out, partials, kv_self, mod, gemm_launches, B, T, D, E, H, L, int8,
    # vpu_bf16, mxu_f32, stream (gemm_launches: a host int the call raises by
    # one for each AdaLN GEMM launch, as adaln_modulation_forward's launches)
    "decoder_stack_forward": ([_P] * 14 + [_I] * 9 + [_P], _I),
    # x, emb, kv_cross, mats, vecs, adaln_w, adaln_b, out, partials, kv_self, mod,
    # gemm_launches, B, T, t_valid, D, E, H, mxu_f32, stream
    "decoder_layer_forward": ([_P] * 12 + [_I] * 7 + [_P], _I),
    # T, t_valid, f32, out (8 int32: pass A's threads, tiles, shared bytes;
    # pass B's threads, blocks; pass C's threads, tiles, shared bytes) -> 0
    "decoder_stack_plan": ([_I] * 3 + [_P], _I),
    # B, T, D, E, H, mxu_f32 -> workspace bytes of decoder_layer_backward
    "decoder_layer_backward_workspace": ([_I] * 6, ctypes.c_longlong),
    # x, emb, kv_cross, mats, vecs, adaln_w, adaln_b, dy, dx, demb, dkv_cross,
    # dmats, dvecs, dadaln_w, dadaln_b, workspace, gemm_launches, B, T, t_valid,
    # D, E, H, mxu_f32, stream
    "decoder_layer_backward": ([_P] * 17 + [_I] * 7 + [_P], _I),
    # T, f32, out (5 int32: the row passes' threads, tiles, shared bytes; the
    # GEMM launches' threads, dynamic shared bytes) -> 0
    "decoder_layer_backward_plan": ([_I] * 2 + [_P], _I),
}
for _name, _sig in WIDTH_SIGNATURES.items():
    for _d in WIDTHS:
        SIGNATURES[f"{_name}_d{_d}"] = _sig


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_log() -> Path:
    """nvcc's output of the last build (ptxas register / shared-memory use)."""
    return BUILD_DIR / "nvcc.log"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    # (source, extra flags, object tag): the width sources once per width
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        if src.name in WIDTH_SOURCES:
            jobs += [(src, [f"-DLAYER_D={d}"], f"{src.stem}_d{d}") for d in WIDTHS]
        else:
            jobs.append((src, [], src.stem))
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *map(str, WIDTHS), *WIDTH_SOURCES]).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libconductor_kernels-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{tag}.o") for _, _, tag in jobs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for (src, flags, _), obj in zip(jobs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        link = None
        if not any(proc.returncode for proc in procs):
            link = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        build_log().write_text("".join(logs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link is None or link.returncode:
            failed = [f"{tag}:\n{log[:3000]}" for (_, _, tag), proc, log in zip(jobs, procs, logs)
                      if proc.returncode] or [logs[-1][-6000:]]
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def width_entry(name: str, d: int):
    """The C entry point ``name`` of the decoder kernels built for model
    width ``d`` (``<name>_d<d>``); ValueError for a width not in `WIDTHS`."""
    if d not in WIDTHS:
        raise ValueError(f"{name}: the decoder kernels are built for D in {WIDTHS}, got D = {d}")
    return getattr(library(), f"{name}_d{d}")


H100_SMS = 132  # an H100 SXM's SMs: the tilings' default card


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index`` (the tilings size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream() -> int:
    """The current CUDA stream's handle, by torch's raw getter (a
    `torch.cuda.current_stream()` object costs several microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel takes a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


def require_aligned(**tensors: torch.Tensor) -> None:
    """Raise unless each tensor starts 16-byte aligned (the kernels copy
    their operands in 16-byte pieces)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes a tensor that starts 16-byte aligned")
