"""One decoder layer, forward (K5), plus the plain PyTorch version.

Port of `conductor_tpu/ops/pallas_layer.py::fused_decoder_layer`
(`_layer_kernel` :163-174, pallas_call at :233): K1's layer math
(`ops/decoder_stack.py`) for one layer per call, as the training path
runs it.  The residual enters and leaves in its storage dtype (bf16 between
the training layers on the card, float32 on the CPU) and is float32 inside
the layer.  ``x`` may carry pad rows past ``t_valid``; they are masked out
of the time softmax and KV and still computed, as in the JAX kernel.

Weights as one layer of `train/fused_denoiser.pack_layer_weights`: mats
(9, D, D), vecs (24, D), adaln_w (E, 6D), adaln_b (6D,), kv_cross (B, D, D)
block-diagonal.  A CPU tensor goes to the plain version; a CUDA tensor to
the kernel in `csrc/decoder_stack.cu` (`decoder_layer_forward`: the AdaLN
GEMM of `csrc/adaln_gemm.cu`, then the layer's passes), which takes D =
128, rows in whole 64-row tiles and operands in ``mxu_dtype``: bf16, or in
its float32 mode float32 (x, emb_act and kv_cross too, as JAX's
`fused_train_denoise` casts them).  `kernel_operands` gives the operands
as the kernels take them: the float32 weight banks rounded to bf16 in the
bf16 mode, as the plain version's matmuls round their operands, and left
float32 in the float32 mode.  Float32 launches count in
``launches_f32``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decoder_stack import (
    ROWS_PER_TILE,
    WIDTHS,
    _count_gemm,
    decoder_stack_plain,
    layer_widths_ok,
)


def decoder_layer_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                        mxu_dtype=torch.float32, t_valid: int | None = None):
    """The plain version of the kernel: `decoder_stack_plain` for one layer,
    the output in ``x.dtype``."""
    out = decoder_stack_plain(x, emb_act, kv_cross[None], mats[None], vecs[None], adaln_w[None],
                              adaln_b[None], num_heads, mxu_dtype=mxu_dtype, t_valid=t_valid)
    return out.to(x.dtype)


def _check_kernel_args(x, emb_act, num_heads, mxu_dtype):
    b, t, d = x.shape
    e = emb_act.shape[-1]
    dh = d // num_heads
    if (mxu_dtype not in (torch.bfloat16, torch.float32) or x.dtype != mxu_dtype
            or not layer_widths_ok(d, num_heads) or e % 64 or t % ROWS_PER_TILE):
        raise ValueError(
            f"the decoder-layer kernels take x and operands in one of bf16 and float32, D in "
            f"{WIDTHS}, E % 64 == 0, a head width dividing 32 and T a multiple of "
            f"{ROWS_PER_TILE}; got {x.dtype} x, {mxu_dtype} operands, D={d}, E={e}, "
            f"H={num_heads}, T={t}"
        )
    return b, t, d, e, dh


def kernel_operands(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                    mxu_dtype, dy=None) -> dict[str, torch.Tensor]:
    """K5's (and, with ``dy``, K6's) operands as the kernels take them, on
    any device: x, emb_act and kv_cross as given, which must be in
    ``mxu_dtype`` (bf16 or float32) at the shapes the kernels take; the
    matrices ``mats`` and ``adaln_w`` and the cotangent ``dy`` in
    ``mxu_dtype`` (rounded to bf16 in the bf16 mode, left float32 in the
    float32 mode); ``vecs`` and ``adaln_b`` float32; all contiguous.
    Raises ValueError on what the kernels do not take."""
    b, t, d, e, _ = _check_kernel_args(x, emb_act, num_heads, mxu_dtype)
    given = {"emb_act": (emb_act, (b, t, e)), "kv_cross": (kv_cross, (b, d, d)),
             "mats": (mats, (9, d, d)), "vecs": (vecs, (24, d)), "adaln_w": (adaln_w, (e, 6 * d)),
             "adaln_b": (adaln_b, (6 * d,)), **({} if dy is None else {"dy": (dy, (b, t, d))})}
    for name, (a, shape) in given.items():
        if tuple(a.shape) != shape or (name in ("emb_act", "kv_cross") and a.dtype != mxu_dtype):
            raise ValueError(f"{name}: the decoder-layer kernels take shape {shape} (emb_act "
                             f"and kv_cross in {mxu_dtype}), got {a.dtype} {tuple(a.shape)}")
    f32 = torch.float32
    ops = dict(x=x, emb_act=emb_act, kv_cross=kv_cross, mats=mats.to(mxu_dtype).contiguous(),
               vecs=vecs.to(f32).contiguous(), adaln_w=adaln_w.to(mxu_dtype).contiguous(),
               adaln_b=adaln_b.to(f32).contiguous())
    if dy is not None:
        ops["dy"] = dy.to(mxu_dtype).contiguous()
    return ops


def fused_decoder_layer(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                        mxu_dtype=torch.float32, t_valid: int | None = None):
    """x (B, T, D), emb_act (B, T, E) -> (B, T, D) in ``x.dtype``."""
    if not x.is_cuda:
        return decoder_layer_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b,
                                   num_heads, mxu_dtype=mxu_dtype, t_valid=t_valid)
    ops = kernel_operands(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads,
                          mxu_dtype=mxu_dtype)
    b, t, d = x.shape
    e, dh = emb_act.shape[-1], d // num_heads
    t_valid = t if t_valid is None else t_valid
    f32, mode_f32 = torch.float32, mxu_dtype == torch.float32
    for name in ("x", "emb_act", "kv_cross", "mats", "adaln_w"):
        _build.require(ops[name], name, mxu_dtype, tuple(ops[name].shape))
    _build.require_aligned(**{k: ops[k] for k in ("x", "emb_act", "kv_cross", "mats", "adaln_w")})
    n_tiles = -(-t_valid // ROWS_PER_TILE)
    out = torch.empty_like(x)
    partials = torch.empty((b, n_tiles, 2 * d + d * dh), dtype=f32, device=x.device)
    kv_self = torch.empty((b, d, d), dtype=mxu_dtype, device=x.device)
    mod = torch.empty((b * t, 6 * d), dtype=f32, device=x.device)  # the AdaLN modulation
    gemm_launches = ctypes.c_int(0)
    err = _build.width_entry("decoder_layer_forward", d)(
        x.data_ptr(), emb_act.data_ptr(), kv_cross.data_ptr(), ops["mats"].data_ptr(),
        ops["vecs"].data_ptr(), ops["adaln_w"].data_ptr(), ops["adaln_b"].data_ptr(),
        out.data_ptr(), partials.data_ptr(), kv_self.data_ptr(), mod.data_ptr(),
        ctypes.addressof(gemm_launches), b, t, t_valid, d, e, num_heads, int(mode_f32),
        _build.stream(),
    )
    _build.check(err, "decoder_layer_forward")
    if mode_f32:
        fused_decoder_layer.launches_f32 += 1
    else:
        fused_decoder_layer.launches += 1
    _count_gemm(mxu_dtype, gemm_launches.value)
    return out


fused_decoder_layer.launches = 0
fused_decoder_layer.launches_f32 = 0
