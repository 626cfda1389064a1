"""One decoder layer's backward (K6), and the differentiable layer built
from K5 and K6.

Port of `conductor_tpu/ops/pallas_layer_bwd.py::fused_decoder_layer_train`
(the custom_vjp :352-401; `_layer_bwd_kernel` :74-296, pallas_call at
:321).  `fused_decoder_layer_train` is a `torch.autograd.Function`: its
forward is K5 (`ops/decoder_layer.fused_decoder_layer`), its backward
`decoder_layer_bwd`, which returns the seven gradients of the JAX custom_vjp:
dx, d_emb_act, d_kv_cross, d_mats (9, D, D), d_vecs (24, D), d_adaln_w
(E, 6D) and d_adaln_b (6D,), each in its input's dtype (the kernel computes
the four weight gradients in float32, as the JAX kernel's `out_shapes`).
Rows at or past ``t_valid`` are masked as in the forward and carry no
gradient into the weights.

On CPU tensors `decoder_layer_bwd` is its plain version,
`decoder_layer_bwd_plain`: `torch.autograd.grad` through
`decoder_layer_plain`.  On CUDA tensors it launches the kernel in
`csrc/decoder_layer_bwd.cu` (several launches, one C call: the AdaLN GEMM
of `csrc/adaln_gemm.cu` among them, counted in `adaln_modulation`'s
``launches`` or ``launches_f32`` as the C call reports it) or raises.  Its
operands are those of `ops.decoder_layer.kernel_operands`: bf16, or in the
float32 mode (``mxu_dtype=torch.float32``) float32, the cotangent too; the
float32 launches count in ``launches_f32``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decoder_layer import decoder_layer_plain, fused_decoder_layer, kernel_operands
from .decoder_stack import ROWS_TILE_C, _count_gemm
from .decoder_stack import plan as stack_plan

GEMM_THREADS = 256       # the A^T B and d_emb launches' threads (csrc kGemmThreads)
GEMM_SMEM = 3 * 32768    # their 3-stage ring of two 16-KB operand tiles (kGemmSmem)


def plan(d: int, t: int, f32: bool = False) -> dict[str, int]:
    """The launches of one K6 call at width ``d`` for clips of ``t`` rows
    (a multiple of 64), bf16 or float32 (``f32``), as
    `csrc/decoder_layer_bwd.cu` makes them (its
    `decoder_layer_backward_plan_d<D>` export gives the same): the two row
    passes 8 warps over 32-row tiles with pass C's shared layout, the A^T B
    and d_emb launches 256 threads on a 96-KB ring (d_emb's float32 kernel
    uses static shared memory)."""
    c = stack_plan(d, t, f32=f32)
    return {"rows_threads": c["c_threads"], "rows_tiles": t // ROWS_TILE_C,
            "rows_smem": c["c_smem"], "gemm_threads": GEMM_THREADS, "gemm_smem": GEMM_SMEM}


def kernel_plan(d: int, t: int, f32: bool = False) -> dict[str, int]:
    """`plan` as the built kernel reports it."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.width_entry("decoder_layer_backward_plan", d)(t, int(f32), out),
                 "decoder_layer_backward_plan")
    return dict(zip(plan(d, t, f32), out))


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
    ops = kernel_operands(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads,
                          mxu_dtype=mxu_dtype, dy=dy)
    b, t, d = x.shape
    e = emb_act.shape[-1]
    t_valid = t if t_valid is None else t_valid
    f32, mode_f32 = torch.float32, mxu_dtype == torch.float32
    for name in ("x", "emb_act", "kv_cross", "mats", "adaln_w", "dy"):
        _build.require(ops[name], name, mxu_dtype, tuple(ops[name].shape))
    _build.require_aligned(**{k: ops[k] for k in ("x", "emb_act", "mats", "adaln_w", "dy")})
    ws_bytes = _build.width_entry("decoder_layer_backward_workspace", d)(
        b, t, d, e, num_heads, int(mode_f32))
    if ws_bytes < 0:
        raise ValueError(f"decoder_layer_bwd: the kernel does not take D={d}, E={e}, H={num_heads}")
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    dx, demb, dkvc = torch.empty_like(x), torch.empty_like(emb_act), torch.empty_like(kv_cross)
    dmats = torch.empty((9, d, d), dtype=f32, device=x.device)
    dvecs = torch.empty((24, d), dtype=f32, device=x.device)
    daw = torch.empty((e, 6 * d), dtype=f32, device=x.device)
    dab = torch.empty((6 * d,), dtype=f32, device=x.device)
    gemm_launches = ctypes.c_int(0)
    err = _build.width_entry("decoder_layer_backward", d)(
        x.data_ptr(), emb_act.data_ptr(), kv_cross.data_ptr(), *(ops[k].data_ptr() for k in (
            "mats", "vecs", "adaln_w", "adaln_b", "dy")), dx.data_ptr(), demb.data_ptr(),
        dkvc.data_ptr(), dmats.data_ptr(), dvecs.data_ptr(), daw.data_ptr(), dab.data_ptr(),
        workspace.data_ptr(), ctypes.addressof(gemm_launches), b, t, t_valid, d, e, num_heads,
        int(mode_f32), _build.stream(),
    )
    _count_gemm(mxu_dtype, gemm_launches.value)
    _build.check(err, "decoder_layer_backward")
    if mode_f32:
        decoder_layer_bwd.launches_f32 += 1
    else:
        decoder_layer_bwd.launches += 1
    return (dx, demb, dkvc, dmats.to(mats.dtype), dvecs.to(vecs.dtype), daw.to(adaln_w.dtype),
            dab.to(adaln_b.dtype))


decoder_layer_bwd.launches = 0
decoder_layer_bwd.launches_f32 = 0


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
