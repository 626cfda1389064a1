"""Sampler glue kernels around the decoder stack (K2, K3), plus their plain
PyTorch versions and the DDIM affine tables.

Port of `conductor_tpu/ops/pallas_sampler.py`:

- `ddim_affine_tables` (`:41-55`): per-step (alpha, beta) with
  x_{t-1} = alpha * x0 + beta * x_t, the eta=0 DDIM update under START_X
  folded into two scalars (numpy, from the float32 schedule tables, as in
  the JAX package);
- `sampler_prologue` (K2, `:80-126`): emb_act = silu(temb[t] + emb_base) and
  h0 = x @ W_joint + seq_bias.  The add of the time-embedding row, which the
  JAX path does just outside its kernel, is fused in.  With
  ``quantize_emb`` (the int8-AdaLN mode) emb_act leaves as int8 codes and
  float32 row scales (`emb_activation`, `:58-72`);
- `sampler_epilogue` (K3, `:143-174`): x0 = h @ W_out + b_out and the DDIM
  update.

The pose stays 26 wide (no 128-lane padding).  A CPU tensor goes to the
plain version, a CUDA tensor to the kernel in `csrc/sampler_glue.cu`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .conv_block import _q
from .decoder_stack import quantize_rows


def ddim_affine_tables(sched) -> tuple[np.ndarray, np.ndarray]:
    """(alpha, beta) float32 tables of the eta=0 DDIM update:
        eps    = (sqrt_recip_ab * x_t - x0) / sqrt_recipm1_ab
        x_next = sqrt(ab_prev) * x0 + sqrt(1 - ab_prev) * eps"""
    ab_prev = sched.alphas_cumprod_prev.cpu().numpy()
    sr = sched.sqrt_recip_alphas_cumprod.cpu().numpy()
    srm1 = sched.sqrt_recipm1_alphas_cumprod.cpu().numpy()
    coef = np.sqrt(np.maximum(1.0 - ab_prev, 0.0)) / srm1
    alpha = np.sqrt(ab_prev) - coef
    beta = coef * sr
    return alpha.astype(np.float32), beta.astype(np.float32)


def emb_activation(emb, *, emb_dtype=torch.float32, quantize_emb: bool = False):
    """The decoder stack's emb_act from the float32 ``emb * sigmoid(emb)``:
    (emb_act in ``emb_dtype``, None), or with ``quantize_emb`` (int8 codes,
    float32 row scales) by `decoder_stack.quantize_rows`."""
    emb_act = emb * torch.sigmoid(emb)
    if quantize_emb:
        return quantize_rows(emb_act)
    return emb_act.to(emb_dtype), None


def sampler_prologue_plain(x, temb, emb_base, w_joint, seq_bias, *,
                           mxu_dtype=torch.float32, emb_dtype=torch.float32,
                           quantize_emb: bool = False):
    h = _q(x, mxu_dtype) @ _q(w_joint, mxu_dtype) + seq_bias[: x.shape[1]]
    return (h, *emb_activation(temb + emb_base, emb_dtype=emb_dtype, quantize_emb=quantize_emb))


def sampler_prologue(x, temb, emb_base, w_joint, seq_bias, *,
                     mxu_dtype=torch.float32, emb_dtype=torch.float32, quantize_emb: bool = False):
    """x (B, T, C) pose, temb (E,) the step's time-embedding row, emb_base
    (B, T, E), w_joint (C, D), seq_bias (>= T, D) = seq_emb + b_joint ->
    (h (B, T, D) float32, emb_act (B, T, E) ``emb_dtype``, None), or with
    ``quantize_emb`` (h, emb_q (B, T, E) int8, emb_scale (B, T, 1)
    float32)."""
    if not x.is_cuda:
        return sampler_prologue_plain(x, temb, emb_base, w_joint, seq_bias, mxu_dtype=mxu_dtype,
                                      emb_dtype=emb_dtype, quantize_emb=quantize_emb)
    b, t, c = x.shape
    e, d = emb_base.shape[-1], w_joint.shape[-1]
    if (emb_dtype != torch.bfloat16 and not quantize_emb) or mxu_dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError("sampler_prologue kernel writes bf16 or int8 emb_act; mxu_dtype bf16 "
                         "or f32")
    f32 = torch.float32
    _build.require(x, "x", f32, (b, t, c))
    _build.require(temb, "temb", f32, (e,))
    _build.require(emb_base, "emb_base", f32, (b, t, e))
    _build.require(w_joint, "w_joint", f32, (c, d))
    if seq_bias.shape[0] < t:
        raise ValueError(f"seq_bias has {seq_bias.shape[0]} rows for T={t}")
    _build.require(seq_bias, "seq_bias", f32, (seq_bias.shape[0], d))
    h = torch.empty((b, t, d), dtype=f32, device=x.device)
    emb_act = torch.empty((b, t, e), dtype=torch.int8 if quantize_emb else torch.bfloat16,
                          device=x.device)
    emb_scale = torch.empty((b, t, 1), dtype=f32, device=x.device) if quantize_emb else None
    err = _build.library().sampler_prologue_forward(
        x.data_ptr(), temb.data_ptr(), emb_base.data_ptr(), w_joint.data_ptr(),
        seq_bias.data_ptr(), h.data_ptr(), emb_act.data_ptr(),
        emb_scale.data_ptr() if quantize_emb else None,
        b, t, c, d, e, int(mxu_dtype == torch.bfloat16), _build.stream(),
    )
    _build.check(err, "sampler_prologue_forward")
    if quantize_emb:
        sampler_prologue.launches_int8 += 1
    else:
        sampler_prologue.launches += 1
    return h, emb_act, emb_scale


def sampler_epilogue_plain(h, x_t, w_out, b_out, alpha, beta, *, mxu_dtype=torch.float32):
    x0 = _q(h, mxu_dtype) @ _q(w_out, mxu_dtype) + b_out
    return alpha * x0 + beta * x_t


def sampler_epilogue(h, x_t, w_out, b_out, alpha: float, beta: float, *,
                     mxu_dtype=torch.float32):
    """h (B, T, D), x_t (B, T, C), w_out (D, C), b_out (C,) ->
    x_{t-1} = alpha * (h @ w_out + b_out) + beta * x_t, float32."""
    alpha, beta = float(alpha), float(beta)
    if not h.is_cuda:
        return sampler_epilogue_plain(h, x_t, w_out, b_out, alpha, beta, mxu_dtype=mxu_dtype)
    b, t, d = h.shape
    c = x_t.shape[-1]
    if mxu_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"sampler_epilogue kernel: mxu_dtype bf16 or f32, got {mxu_dtype}")
    f32 = torch.float32
    _build.require(h, "h", f32, (b, t, d))
    _build.require(x_t, "x_t", f32, (b, t, c))
    _build.require(w_out, "w_out", f32, (d, c))
    _build.require(b_out, "b_out", f32, (c,))
    out = torch.empty_like(x_t)
    err = _build.library().sampler_epilogue_forward(
        h.data_ptr(), x_t.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(),
        alpha, beta, b, t, d, c, int(mxu_dtype == torch.bfloat16), _build.stream(),
    )
    _build.check(err, "sampler_epilogue_forward")
    sampler_epilogue.launches += 1
    return out


sampler_prologue.launches = 0
sampler_prologue.launches_int8 = 0
sampler_epilogue.launches = 0
