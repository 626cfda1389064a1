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
GEMM of `csrc/adaln_gemm.cu`, then the layer's passes), which takes bf16
operands, D = 128 and rows in whole 64-row tiles.  The wrapper
rounds the float32 weight banks to bf16 for it, as the plain version's
matmuls round their operands.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decoder_stack import ROWS_PER_TILE, adaln_modulation, decoder_stack_plain


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
    if (mxu_dtype != torch.bfloat16 or x.dtype != torch.bfloat16 or d != 128 or e % 64
            or 32 % dh or dh * num_heads != d or t % ROWS_PER_TILE):
        raise ValueError(
            f"the decoder-layer kernels take bf16 x and operands, D = 128, E % 64 == 0, a head "
            f"width dividing 32 and T a multiple of {ROWS_PER_TILE}; got {x.dtype} x, "
            f"{mxu_dtype} operands, D={d}, E={e}, H={num_heads}, T={t}"
        )
    return b, t, d, e, dh


def kernel_weights(mats, vecs, adaln_w, adaln_b):
    """The weight banks in the kernels' dtypes: bf16 matrices, float32
    vectors, all contiguous."""
    bf, f32 = torch.bfloat16, torch.float32
    return (mats.to(bf).contiguous(), vecs.to(f32).contiguous(), adaln_w.to(bf).contiguous(),
            adaln_b.to(f32).contiguous())


def fused_decoder_layer(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                        mxu_dtype=torch.float32, t_valid: int | None = None):
    """x (B, T, D), emb_act (B, T, E) -> (B, T, D) in ``x.dtype``."""
    if not x.is_cuda:
        return decoder_layer_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b,
                                   num_heads, mxu_dtype=mxu_dtype, t_valid=t_valid)
    b, t, d, e, dh = _check_kernel_args(x, emb_act, num_heads, mxu_dtype)
    t_valid = t if t_valid is None else t_valid
    mats, vecs, adaln_w, adaln_b = kernel_weights(mats, vecs, adaln_w, adaln_b)
    bf, f32 = torch.bfloat16, torch.float32
    _build.require(x, "x", bf, (b, t, d))
    _build.require(emb_act, "emb_act", bf, (b, t, e))
    _build.require(kv_cross, "kv_cross", bf, (b, d, d))
    _build.require_aligned(x=x, emb_act=emb_act, kv_cross=kv_cross, mats=mats, adaln_w=adaln_w)
    n_tiles = -(-t_valid // ROWS_PER_TILE)
    out = torch.empty_like(x)
    partials = torch.empty((b, n_tiles, 2 * d + d * dh), dtype=f32, device=x.device)
    kv_self = torch.empty((b, d, d), dtype=bf, device=x.device)
    mod = torch.empty((b * t, 6 * d), dtype=f32, device=x.device)  # the AdaLN modulation
    gemm_launches = ctypes.c_int(0)
    err = _build.library().decoder_layer_forward(
        x.data_ptr(), emb_act.data_ptr(), kv_cross.data_ptr(), mats.data_ptr(),
        vecs.data_ptr(), adaln_w.data_ptr(), adaln_b.data_ptr(), out.data_ptr(),
        partials.data_ptr(), kv_self.data_ptr(), mod.data_ptr(), ctypes.addressof(gemm_launches),
        b, t, t_valid, d, e, num_heads, _build.stream(),
    )
    _build.check(err, "decoder_layer_forward")
    fused_decoder_layer.launches += 1
    adaln_modulation.launches += gemm_launches.value
    return out


fused_decoder_layer.launches = 0
