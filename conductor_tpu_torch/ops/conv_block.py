"""One music-encoder Conv2dResBlock as a fused kernel (K4), plus its plain
PyTorch version.

Port of `conductor_tpu/ops/pallas_conv.py::fused_conv_block` (and
`fold_bn`, `:68-72`): 3x3 conv with reflection padding -> folded-BN affine
-> ReLU -> residual (none / identity / 1x1 conv + folded BN) -> optional
max-pool epilogue (time stride 1 or 3, freq stride 2, -inf padding).  As
there, ``relu=False`` drops the ReLU and ``edge="zero"`` pads the conv with
zeros: the trainable conv (`conv_train.py`) runs its forward and the
interior of its transposed conv through these two modes.  Layout
is the JAX package's NHWC (B, T, F, C); the kernel weights are (3, 3, Cin,
Cout) and the residual 1x1 weights (Cin, Cout).

`fused_conv_block` takes a CPU tensor to `conv_block_plain` and a CUDA
tensor to the kernel in `csrc/conv_block.cu` (one launch; a pooled block
writes only the pooled tensor); on CUDA it raises on what the kernel does
not take.  Matmul operands are rounded to ``mxu_dtype`` and products summed
in float32 on both paths, as the JAX kernel body does.  The kernel has two
modes, chosen by ``mxu_dtype``: bf16 operands on the tensor cores
(``launches``), and float32 operands with float32 products on the CUDA
cores, x and the output float32, the weights unrounded (``launches_f32``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def fold_bn(conv_bias, bn_mean, bn_var, bn_scale, bn_bias, eps=1e-5):
    """(conv + bias) -> BN(running stats) as one affine y * s + b."""
    s = bn_scale / torch.sqrt(bn_var + eps)
    return s, (conv_bias - bn_mean) * s + bn_bias


def _q(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the matmul operand dtype, compute in float32."""
    return a.to(dtype).float()


def pooled_size(n: int, window: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - window) // stride + 1


def conv_block_plain(
    x, kernel, scale, bias, *, res_mode=0, res_kernel=None, res_scale=None,
    res_bias=None, pool=None, mxu_dtype=torch.bfloat16, relu=True, edge="reflect",
):
    """The plain version of the kernel: same arguments, same result."""
    xn = _q(x, mxu_dtype).permute(0, 3, 1, 2)  # (B, Cin, T, F)
    w = _q(kernel, mxu_dtype).permute(3, 2, 0, 1)  # (Cout, Cin, 3, 3)
    y = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode="reflect" if edge == "reflect" else "constant"), w)
    y = y * scale[:, None, None] + bias[:, None, None]
    if relu:
        y = torch.relu(y)
    if res_mode == 1:
        y = y + x.float().permute(0, 3, 1, 2)
    elif res_mode == 2:
        r = torch.einsum("bctf,cd->bdtf", xn, _q(res_kernel, mxu_dtype))
        y = y + r * res_scale[:, None, None] + res_bias[:, None, None]
    if pool is not None:
        window, strides, padding = pool
        y = F.max_pool2d(y, window, strides, (padding[0][0], padding[1][0]))
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _pool_args(t: int, f: int, pool) -> tuple[int, ...]:
    """(wt, wf, st, sf, pt, pf, To, Fo) of ``pool`` on a (T, F) input, all 0
    without one."""
    if pool is None:
        return (0,) * 8
    (wt, wf), (st, sf), ((pt, pt1), (pf, pf1)) = pool
    if pt != pt1 or pf != pf1 or not (0 <= pt < wt and 0 <= pf < wf):
        raise ValueError(f"conv_block kernel: pool padding must be symmetric and below the "
                         f"window, got {pool}")
    return wt, wf, st, sf, pt, pf, pooled_size(t, wt, st, pt), pooled_size(f, wf, sf, pf)


def kernel_plan(shape, cout: int, *, res_mode: int = 0, pool=None) -> dict:
    """The tiling the kernel picks for an input of ``shape`` (B, T, F, Cin):
    conv rows and pooled rows a tile, ring stages, blocks an SM, blocks,
    tiles and shared-memory bytes.  Builds the kernel library (no card
    needed)."""
    b, t, f, cin = shape
    out = (ctypes.c_int * 7)()
    err = _build.library().conv_block_plan(b, t, f, cin, cout, res_mode, *_pool_args(t, f, pool),
                                           out)
    _build.check(err, "conv_block_plan")
    return dict(zip(("conv_rows", "pooled_rows", "stages", "blocks_per_sm", "blocks", "tiles",
                     "smem_bytes"), out))


def fused_conv_block(
    x, kernel, scale, bias, *, res_mode=0, res_kernel=None, res_scale=None,
    res_bias=None, pool=None, mxu_dtype=torch.bfloat16, relu=True, edge="reflect",
):
    """x (B, T, F, Cin) -> (B, T, F, Cout), or the pooled (B, T', F', Cout)."""
    if edge not in ("reflect", "zero"):
        raise ValueError(f"edge must be 'reflect' or 'zero', got {edge!r}")
    if not x.is_cuda:
        return conv_block_plain(x, kernel, scale, bias, res_mode=res_mode, res_kernel=res_kernel,
                                res_scale=res_scale, res_bias=res_bias, pool=pool,
                                mxu_dtype=mxu_dtype, relu=relu, edge=edge)
    b, t, f, cin = x.shape
    cout = kernel.shape[-1]
    if mxu_dtype not in (torch.bfloat16, torch.float32) or cin not in (1, 16, 32) or cout not in (
            16, 32):
        raise ValueError(
            f"conv_block kernel takes bf16 or float32 operands, Cin in (1, 16, 32) and Cout in "
            f"(16, 32); got {mxu_dtype}, Cin={cin}, Cout={cout}"
        )
    if t < 2 or f < 2 or res_mode not in (0, 1, 2) or (res_mode == 1 and cin != cout):
        raise ValueError(f"conv_block kernel: bad shape {tuple(x.shape)} / res_mode {res_mode}")
    f32 = torch.float32
    _build.require(x, "x", mxu_dtype, (b, t, f, cin))
    _build.require(kernel, "kernel", f32, (3, 3, cin, cout))
    _build.require(scale, "scale", f32, (cout,))
    _build.require(bias, "bias", f32, (cout,))
    if res_mode == 2:
        _build.require(res_kernel, "res_kernel", f32, (cin, cout))
        _build.require(res_scale, "res_scale", f32, (cout,))
        _build.require(res_bias, "res_bias", f32, (cout,))
    res = (res_kernel, res_scale, res_bias) if res_mode == 2 else (None, None, None)
    pool_args = _pool_args(t, f, pool)
    shape = (b, t, f, cout) if pool is None else (b, *pool_args[6:], cout)
    out = torch.empty(shape, dtype=mxu_dtype, device=x.device)
    mode_f32 = mxu_dtype == f32
    # the float32 mode stages the residual weights by 16-byte loads at Cin = 1 too
    _build.require_aligned(kernel=kernel, **({"x": x} if cin > 1 else {}),
                           **({"res_kernel": res_kernel}
                              if res_mode == 2 and (cin > 1 or mode_f32) else {}))
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    name = "conv_block_forward_f32" if mode_f32 else "conv_block_forward"
    err = getattr(_build.library(), name)(
        ptr(x), ptr(kernel), ptr(scale), ptr(bias), *map(ptr, res), ptr(out),
        b, t, f, cin, cout, res_mode, int(relu), int(edge == "zero"), *pool_args,
        _build.stream(),
    )
    _build.check(err, name)
    if mode_f32:
        fused_conv_block.launches_f32 += 1
    else:
        fused_conv_block.launches += 1
    return out


fused_conv_block.launches = 0
fused_conv_block.launches_f32 = 0
