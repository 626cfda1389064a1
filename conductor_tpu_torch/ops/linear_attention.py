"""Linear (kernelized) temporal attention.

Port of `qk_softmax`, `linear_attention` and `temporal_linear_attention`
(`conductor_tpu/ops/linear_attention.py:26-86`): q is softmaxed over each
head's features, k over time, and y = q (k^T v), O(T d^2).  Masked key rows
get an additive -1e6 before the time softmax and masked value rows are
zeroed, as in the reference.

``impl="xla"`` is the module math in the inputs' dtypes with JAX's type
promotion: a float32 ``key_mask`` makes bf16 k and v float32 (``k + (1 -
mask) * -1e6``, ``v * mask``) while q's softmax stays in q's dtype, and each
contraction runs in the promoted dtype of its operands.  ``impl="pallas"``
is the K8 kernel's wrapper, `ops.attention.fused_linear_attention`.
"""

from __future__ import annotations

import torch

from .attention import fold_key_mask, fused_linear_attention

IMPLS = ("xla", "pallas")


def qk_softmax(q, k, num_heads: int):
    """q, k: (B, T, D) -> (B, T, H, Dh) with q softmaxed over the head
    features and k over time (a key mask is folded into k before,
    `ops.attention.fold_key_mask`)."""
    b, t, d = q.shape
    q = torch.softmax(q.reshape(b, t, num_heads, d // num_heads), dim=-1)
    k = torch.softmax(k.reshape(b, -1, num_heads, d // num_heads), dim=1)
    return q, k


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def linear_attention(q, k, v):
    """q (B, Tq, H, Dh), k and v (B, Tk, H, Dh) -> (B, Tq, H*Dh)."""
    b, tq, h, dh = q.shape
    kv = _einsum("bnhd,bnhl->bhdl", k, v)
    return _einsum("bnhd,bhdl->bnhl", q, kv).reshape(b, tq, h * dh)


def temporal_linear_attention(q, k, v, num_heads: int, key_mask: torch.Tensor | None,
                              impl: str = "xla"):
    """q, k, v: (B, T, D) pre-softmax projections -> (B, T, D)."""
    if impl == "pallas":
        return fused_linear_attention(q, k, v, num_heads, key_mask)
    if impl != "xla":
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    k, v = fold_key_mask(k, v, key_mask)
    b, _, d = q.shape
    qs, ks = qk_softmax(q, k, num_heads)
    return linear_attention(qs, ks, v.reshape(b, -1, num_heads, d // num_heads))
