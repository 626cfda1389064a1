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
tensor to the kernel in `csrc/conv_block.cu`; on CUDA it raises on what
the kernel does not take.  Matmul operands are rounded to ``mxu_dtype`` and
products summed in float32 on both paths, as the JAX kernel body does.
"""

from __future__ import annotations

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


def fused_conv_block(
    x, kernel, scale, bias, *, res_mode=0, res_kernel=None, res_scale=None,
    res_bias=None, pool=None, mxu_dtype=torch.bfloat16, relu=True, edge="reflect",
):
    """x (B, T, F, Cin) -> (B, T, F, Cout), or the pooled (B, T', F', Cout)."""
    if edge not in ("reflect", "zero"):
        raise ValueError(f"edge must be 'reflect' or 'zero', got {edge!r}")
    args = dict(res_mode=res_mode, res_kernel=res_kernel, res_scale=res_scale,
                res_bias=res_bias, pool=pool, mxu_dtype=mxu_dtype, relu=relu, edge=edge)
    if not x.is_cuda:
        return conv_block_plain(x, kernel, scale, bias, **args)
    b, t, f, cin = x.shape
    cout = kernel.shape[-1]
    if mxu_dtype != torch.bfloat16 or cin not in (1, 16, 32) or cout not in (16, 32):
        raise ValueError(
            f"conv_block kernel takes bf16 operands, Cin in (1, 16, 32) and Cout in "
            f"(16, 32); got {mxu_dtype}, Cin={cin}, Cout={cout}"
        )
    if t < 2 or f < 2 or res_mode not in (0, 1, 2) or (res_mode == 1 and cin != cout):
        raise ValueError(f"conv_block kernel: bad shape {tuple(x.shape)} / res_mode {res_mode}")
    f32 = torch.float32
    _build.require(x, "x", torch.bfloat16, (b, t, f, cin))
    _build.require(kernel, "kernel", f32, (3, 3, cin, cout))
    _build.require(scale, "scale", f32, (cout,))
    _build.require(bias, "bias", f32, (cout,))
    if res_mode == 2:
        _build.require(res_kernel, "res_kernel", f32, (cin, cout))
        _build.require(res_scale, "res_scale", f32, (cout,))
        _build.require(res_bias, "res_bias", f32, (cout,))
    res = (res_kernel, res_scale, res_bias) if res_mode == 2 else (None, None, None)
    conv_out = torch.empty((b, t, f, cout), dtype=torch.bfloat16, device=x.device)
    wt = wf = st = sf = pt = pf = to = fo = 0
    pool_out = None
    if pool is not None:
        (wt, wf), (st, sf), ((pt, _), (pf, _)) = pool
        to, fo = pooled_size(t, wt, st, pt), pooled_size(f, wf, sf, pf)
        pool_out = torch.empty((b, to, fo, cout), dtype=torch.bfloat16, device=x.device)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    err = _build.library().conv_block_forward(
        ptr(x), ptr(kernel), ptr(scale), ptr(bias), *map(ptr, res),
        ptr(conv_out), ptr(pool_out), b, t, f, cin, cout, res_mode, int(relu),
        int(edge == "zero"), wt, wf, st, sf, pt, pf, to, fo, _build.stream(),
    )
    _build.check(err, "conv_block_forward")
    fused_conv_block.launches += 1
    return conv_out if pool_out is None else pool_out


fused_conv_block.launches = 0
