"""The music encoder's max-pool as a kernel (K10) with a first-max backward
kernel (K11), plus their plain PyTorch versions.

Port of `conductor_tpu/ops/pallas_pool.py`: `fused_max_pool` (K10, :163)
and `max_pool_train` (:442), whose backward (`_make_pool_op`, :352, kernel
`_pool_bwd_kernel`, :260) routes each output window's cotangent to ONE input
position: the first freq tap, in ascending order, whose time-pooled column
maximum equals the window maximum, and in that column the first time tap,
in ascending order, that attains it (:219-232, :277-343).  PyTorch's
`max_pool2d` backward breaks ties its own way, and post-ReLU zero plateaus
are common, so the plain backward is written out (unfold, first argmax,
scatter) instead of autograd of `F.max_pool2d`.  Each cotangent goes to
exactly one input, so ``sum dx == sum dy``.

Layout: NHWC (B, T, F, C); ``pool`` is (window, strides, padding) as the
music encoder's `POOLS` give it, padding symmetric and -inf.  The wrappers
take the plain version for CPU tensors; on CUDA they launch the kernels
(`csrc/max_pool.cu`: `max_pool_forward`, `max_pool_backward`) and raise on
what those do not take (bf16 only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .conv_block import pooled_size


def _geometry(x: torch.Tensor, pool):
    (wt, wf), (st, sf), ((pt, pt1), (pf, pf1)) = pool
    if pt != pt1 or pf != pf1 or not (0 <= pt < wt and 0 <= pf < wf):
        raise ValueError(f"max-pool takes symmetric padding below the window, got {pool}")
    _, t, f, _ = x.shape
    return wt, wf, st, sf, pt, pf, pooled_size(t, wt, st, pt), pooled_size(f, wf, sf, pf)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis."""
    n = mask.shape[-1]
    return torch.where(mask, torch.arange(n, device=mask.device), n).amin(-1)


def _column_maxima(x: torch.Tensor, pool):
    """(time windows (B, To, Fp, C, wt) of the -inf padded float32 input,
    their maxima (B, To, Fp, C), freq windows of those (B, To, Fo, C, wf),
    the window maxima (B, To, Fo, C))."""
    wt, wf, st, sf, pt, pf, _, _ = _geometry(x, pool)
    xp = F.pad(x.float(), (0, 0, pf, pf, pt, pt), value=float("-inf"))
    win_t = xp.unfold(1, wt, st)
    cols = win_t.amax(-1)
    win_f = cols.unfold(2, wf, sf)
    return win_t, cols, win_f, win_f.amax(-1)


def max_pool_plain(x: torch.Tensor, pool) -> torch.Tensor:
    """The plain version of K10: the window maxima, written out."""
    return _column_maxima(x, pool)[3].to(x.dtype)


def max_pool_bwd_plain(x: torch.Tensor, dy: torch.Tensor, pool) -> torch.Tensor:
    """The plain version of K11: d(x) of the pool for the cotangent ``dy``
    (B, To, Fo, C), by the first-max rule."""
    b, t, f, c = x.shape
    _, _, st, sf, pt, pf, to, fo = _geometry(x, pool)
    win_t, cols, win_f, y = _column_maxima(x, pool)
    first_t = _first(win_t == cols[..., None])                 # (B, To, Fp, C)
    dev = x.device
    col = torch.arange(fo, device=dev)[:, None] * sf + _first(win_f == y[..., None])
    row = torch.arange(to, device=dev)[:, None, None] * st + first_t.gather(2, col)
    idx = ((torch.arange(b, device=dev)[:, None, None, None] * t + row - pt) * f
           + col - pf) * c + torch.arange(c, device=dev)
    dx = torch.zeros(b * t * f * c, dtype=torch.float32, device=dev)
    dx.index_add_(0, idx.reshape(-1), dy.float().reshape(-1))
    return dx.reshape(x.shape).to(x.dtype)


def fused_max_pool(x: torch.Tensor, pool) -> torch.Tensor:
    """K10: x (B, T, F, C) -> (B, To, Fo, C)."""
    if not x.is_cuda:
        return max_pool_plain(x, pool)
    b, t, f, c = x.shape
    wt, wf, st, sf, pt, pf, to, fo = _geometry(x, pool)
    _build.require(x, "x", torch.bfloat16, (b, t, f, c))
    out = torch.empty((b, to, fo, c), dtype=torch.bfloat16, device=x.device)
    err = _build.library().max_pool_forward(x.data_ptr(), out.data_ptr(), b, t, f, c, to, fo,
                                            wt, wf, st, sf, pt, pf, _build.stream())
    _build.check(err, "max_pool_forward")
    fused_max_pool.launches += 1
    return out


def max_pool_bwd(x: torch.Tensor, dy: torch.Tensor, pool) -> torch.Tensor:
    """K11: d(x) (B, T, F, C) of the pool for ``dy`` (B, To, Fo, C)."""
    if not x.is_cuda:
        return max_pool_bwd_plain(x, dy, pool)
    b, t, f, c = x.shape
    wt, wf, st, sf, pt, pf, to, fo = _geometry(x, pool)
    _build.require(x, "x", torch.bfloat16, (b, t, f, c))
    _build.require(dy, "dy", torch.bfloat16, (b, to, fo, c))
    winner = torch.empty(dy.shape, dtype=torch.int32, device=x.device)
    dx = torch.empty_like(x)
    err = _build.library().max_pool_backward(
        x.data_ptr(), dy.data_ptr(), winner.data_ptr(), dx.data_ptr(), b, t, f, c, to, fo,
        wt, wf, st, sf, pt, pf, _build.stream())
    _build.check(err, "max_pool_backward")
    max_pool_bwd.launches += 1
    return dx


fused_max_pool.launches = 0
max_pool_bwd.launches = 0


class _MaxPoolTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pool):
        ctx.save_for_backward(x)
        ctx.pool = pool
        return fused_max_pool(x, pool)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return max_pool_bwd(x, dy.contiguous(), ctx.pool), None


def max_pool_train(x: torch.Tensor, pool) -> torch.Tensor:
    """Trainable max-pool on NHWC ``x``: K10 forward, K11 backward."""
    return _MaxPoolTrain.apply(x, pool)
