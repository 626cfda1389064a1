"""One decoder layer's backward (K6), and the differentiable layer built
from K5 and K6.

Port of `conductor_tpu/ops/pallas_layer_bwd.py::fused_decoder_layer_train`
(the custom_vjp :352-401; `_layer_bwd_kernel` :74-296, pallas_call at
:321).  `fused_decoder_layer_train` is a `torch.autograd.Function`: its
forward is K5 (`ops/decoder_layer.fused_decoder_layer`), its backward
`decoder_layer_bwd`, which returns the seven gradients of the JAX custom_vjp:
dx, d_emb_act, d_kv_cross, d_mats (9, D, D), d_vecs (24, D), d_adaln_w
(E, 6D) and d_adaln_b (6D,), each in its input's dtype.  Rows at or past
``t_valid`` are masked as in the forward and carry no gradient into the
weights.

On CPU tensors `decoder_layer_bwd` is its plain version,
`decoder_layer_bwd_plain`: `torch.autograd.grad` through
`decoder_layer_plain`.  On CUDA tensors it launches the kernel in
`csrc/decoder_layer_bwd.cu` (several launches, one C call: the AdaLN GEMM
of `csrc/adaln_gemm.cu` among them, counted in `adaln_modulation.launches`
as the C call reports it) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decoder_layer import _check_kernel_args, decoder_layer_plain, fused_decoder_layer, kernel_weights
from .decoder_stack import adaln_modulation


def decoder_layer_bwd_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, dy, num_heads, *,
                            mxu_dtype=torch.float32, t_valid: int | None = None):
    """The plain version of the kernel: the seven gradients of
    ``(decoder_layer_plain(...) * dy).sum()``."""
    inputs = [a.detach().requires_grad_(True)
              for a in (x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b)]
    with torch.enable_grad():
        out = decoder_layer_plain(*inputs, num_heads, mxu_dtype=mxu_dtype, t_valid=t_valid)
        return torch.autograd.grad(out, inputs, dy)


def decoder_layer_bwd(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, dy, num_heads, *,
                      mxu_dtype=torch.float32, t_valid: int | None = None):
    """The seven gradients of the layer at (x, ..., adaln_b) against the
    output cotangent ``dy``."""
    if not x.is_cuda:
        return decoder_layer_bwd_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, dy,
                                       num_heads, mxu_dtype=mxu_dtype, t_valid=t_valid)
    b, t, d, e, _ = _check_kernel_args(x, emb_act, num_heads, mxu_dtype)
    t_valid = t if t_valid is None else t_valid
    bf, f32 = torch.bfloat16, torch.float32
    wm, wv, wa, wb = kernel_weights(mats, vecs, adaln_w, adaln_b)
    dy = dy.to(bf).contiguous()
    _build.require(x, "x", bf, (b, t, d))
    _build.require(emb_act, "emb_act", bf, (b, t, e))
    _build.require(kv_cross, "kv_cross", bf, (b, d, d))
    _build.require_aligned(x=x, emb_act=emb_act, mats=wm, adaln_w=wa, dy=dy)
    lib = _build.library()
    ws_bytes = lib.decoder_layer_backward_workspace(b, t, d, e, num_heads)
    if ws_bytes < 0:
        raise ValueError(f"decoder_layer_bwd: the kernel does not take D={d}, E={e}, H={num_heads}")
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    dx, demb, dkvc = torch.empty_like(x), torch.empty_like(emb_act), torch.empty_like(kv_cross)
    dmats = torch.empty((9, d, d), dtype=f32, device=x.device)
    dvecs = torch.empty((24, d), dtype=f32, device=x.device)
    daw = torch.empty((e, 6 * d), dtype=f32, device=x.device)
    dab = torch.empty((6 * d,), dtype=f32, device=x.device)
    gemm_launches = ctypes.c_int(0)
    err = lib.decoder_layer_backward(
        x.data_ptr(), emb_act.data_ptr(), kv_cross.data_ptr(), wm.data_ptr(), wv.data_ptr(),
        wa.data_ptr(), wb.data_ptr(), dy.data_ptr(), dx.data_ptr(), demb.data_ptr(),
        dkvc.data_ptr(), dmats.data_ptr(), dvecs.data_ptr(), daw.data_ptr(), dab.data_ptr(),
        workspace.data_ptr(), ctypes.addressof(gemm_launches), b, t, t_valid, d, e, num_heads,
        _build.stream(),
    )
    adaln_modulation.launches += gemm_launches.value
    _build.check(err, "decoder_layer_backward")
    decoder_layer_bwd.launches += 1
    return (dx, demb, dkvc, dmats.to(mats.dtype), dvecs.to(vecs.dtype), daw.to(adaln_w.dtype),
            dab.to(adaln_b.dtype))


decoder_layer_bwd.launches = 0


class _LayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, mxu_dtype,
                t_valid):
        ctx.save_for_backward(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b)
        ctx.opts = (num_heads, mxu_dtype, t_valid)
        return fused_decoder_layer(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads,
                                   mxu_dtype=mxu_dtype, t_valid=t_valid)

    @staticmethod
    def backward(ctx, dy):
        num_heads, mxu_dtype, t_valid = ctx.opts
        grads = decoder_layer_bwd(*ctx.saved_tensors, dy, num_heads, mxu_dtype=mxu_dtype,
                                  t_valid=t_valid)
        return (*grads, None, None, None)


def fused_decoder_layer_train(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                              mxu_dtype=torch.bfloat16, t_valid: int | None = None):
    """Differentiable decoder layer on packed weights: K5 forward, K6
    backward.  Pass inputs pre-padded (to the kernel's 64-row tile on the
    card) with ``t_valid`` = the real row count."""
    return _LayerTrain.apply(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads,
                             mxu_dtype, t_valid)
