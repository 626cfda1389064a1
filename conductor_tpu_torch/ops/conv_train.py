"""The trainable reflect-padded 3x3 conv of the music encoder: forward and
d(input) on K4, d(kernel) on its own kernel (K9), plus the plain versions.

Port of `conductor_tpu/ops/conv_train.py::conv3x3_train` (:142-288) on NHWC
tensors, x (B, T, F, Cin) and kernel (3, 3, Cin, Cout):

- forward: K4 (`conv_block.fused_conv_block`) with no affine, no ReLU and
  no residual, reflect edge (:142-156);
- d(input): the adjoint of a reflect-padded conv is a zero-padded conv of
  the cotangent with the flipped, channel-transposed kernel, K4 with
  ``edge="zero"`` (:206-207, :272-285), plus the adjoint of the reflection:
  the four extended border rows and columns fold back onto rows 1 and T-2
  and columns 1 and F-2 (:209-241), a few small products in plain PyTorch,
  as the JAX package leaves them to XLA.  Skipped when x takes no gradient
  (the first block's input is the mel);
- d(kernel): K9 (`csrc/conv_train.cu`), dW[dt, df, ci, co] = sum over
  (b, t, f) of xe[b, t+dt-1, f+df-1, ci] * dy[b, t, f, co], xe the reflect-
  extended input, in (3, 3, Cin, Cout) directly, one tensor-core GEMM per
  tap over the pixels: the TPU kernel's halo layout and its offset-eye fold
  (:243-269) are not carried over.

The kernels take bf16 operands (tensor cores) or float32 operands (float32
products on the CUDA cores: K4's and K9's float32 modes, counted apart as
``launches_f32``), the dtype of x carried through the autograd Function to
both; on CPU tensors the wrappers take the plain versions in the tensors'
own dtype (operands rounded to it, float32 sums).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .conv_block import fused_conv_block


def conv3x3_dkernel_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The plain version of K9: the d(kernel) sum written out, in float32
    (float64 for float64 operands)."""
    t, f = dy.shape[1], dy.shape[2]
    dtype = torch.promote_types(x.dtype, torch.float32)
    xe = F.pad(x.to(dtype).permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    d = dy.to(dtype)
    return torch.stack([
        torch.stack([torch.einsum("btfi,btfo->io", xe[:, a:a + t, c:c + f], d) for c in range(3)])
        for a in range(3)
    ])


def conv3x3_dkernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K9: d(kernel) (3, 3, Cin, Cout) float32 of the reflect-padded 3x3
    conv, for x (B, T, F, Cin) and its output's cotangent dy (B, T, F, Cout),
    both bf16 or both float32 (the float32 mode)."""
    if not x.is_cuda:
        return conv3x3_dkernel_plain(x, dy)
    b, t, f, cin = x.shape
    cout = dy.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3_dkernel takes bf16 or float32 operands, got {x.dtype}")
    _build.require(x, "x", x.dtype, (b, t, f, cin))
    _build.require(dy, "dy", x.dtype, (b, t, f, cout))
    mode_f32 = x.dtype == torch.float32
    name = "conv3x3_dkernel_f32" if mode_f32 else "conv3x3_dkernel"
    lib = _build.library()
    nbytes = getattr(lib, f"{name}_workspace")(b, t, f, cin, cout)
    if nbytes < 0:
        raise ValueError(f"conv3x3_dkernel takes T, F >= 2, Cin in (1, 16, 32), Cout in "
                         f"(16, 32) and a row of x and dy that fits in shared memory; got x "
                         f"{tuple(x.shape)}, dy {tuple(dy.shape)} ({x.dtype})")
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    err = getattr(lib, name)(x.data_ptr(), dy.data_ptr(), workspace.data_ptr(), dw.data_ptr(),
                             b, t, f, cin, cout, _build.stream())
    _build.check(err, name)
    if mode_f32:
        conv3x3_dkernel.launches_f32 += 1
    else:
        conv3x3_dkernel.launches += 1
    return dw


conv3x3_dkernel.launches = 0
conv3x3_dkernel.launches_f32 = 0


def _border_taps(line: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """A 3-tap zero-padded conv along axis 1 of ``line`` (B, N, Cout) with
    ``w3`` (3, Cout, Cin), on the extended range -1..N: (B, N + 2, Cin)."""
    p = F.pad(line, (0, 0, 2, 2))
    n = line.shape[1] + 2
    return sum(p[:, k:k + n] @ w3[k] for k in range(3))


def _fold(ext: torch.Tensor) -> torch.Tensor:
    """The adjoint of a one-element reflection along axis 1: (B, N + 2, C)
    on -1..N -> (B, N, C), with -1 folded onto 1 and N onto N - 2."""
    out = ext[:, 1:-1].clone()
    out[:, 1] += ext[:, 0]
    out[:, -2] += ext[:, -1]
    return out


def conv3x3_input_grad(dy: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """d(input) (B, T, F, Cin) of the reflect-padded conv: K4's zero-edge
    conv of ``dy`` with the flipped, channel-transposed kernel, then the
    reflection's adjoint on the borders, in float32."""
    cin = kernel.shape[2]
    wflip = kernel.float().flip(0, 1).transpose(2, 3).contiguous()  # (3, 3, Cout, Cin)
    ones = torch.ones(cin, dtype=torch.float32, device=dy.device)
    dx = fused_conv_block(dy, wflip, ones, torch.zeros_like(ones), relu=False, edge="zero",
                          mxu_dtype=dy.dtype).float()
    w = wflip.to(dy.dtype).float()  # the operands the kernel rounds to
    d = dy.float()
    dx[:, 1] += _fold(_border_taps(d[:, 0], w[2]))
    dx[:, -2] += _fold(_border_taps(d[:, -1], w[0]))
    dx[:, :, 1] += _border_taps(d[:, :, 0], w[:, 2])[:, 1:-1]
    dx[:, :, -2] += _border_taps(d[:, :, -1], w[:, 0])[:, 1:-1]
    return dx.to(dtype)


class _Conv3x3Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        cout = kernel.shape[-1]
        ones = torch.ones(cout, dtype=torch.float32, device=x.device)
        return fused_conv_block(x, kernel.float().contiguous(), ones, torch.zeros_like(ones),
                                relu=False, mxu_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv3x3_input_grad(dy, kernel, x.dtype) if ctx.needs_input_grad[0] else None
        dw = conv3x3_dkernel(x, dy).to(kernel.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3_train(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Reflect-padded 3x3 conv, x (B, T, F, Cin) -> (B, T, F, Cout), in x's
    dtype; differentiable in x and in ``kernel`` (3, 3, Cin, Cout)."""
    return _Conv3x3Train.apply(x, kernel)
