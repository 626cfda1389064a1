"""K8: the standalone linear self-attention.

Port of `conductor_tpu/ops/pallas_attention.py::fused_linear_attention`
(wrapper :152-168, kernel `_attention_kernel` :45-76, pallas_call at :99,
custom_vjp :133-149).  `fused_linear_attention` adds the reference's key
mask as the JAX wrapper does (``k + (1 - mask) * -1e6``, ``v * mask``; with
a float32 mask, bf16 k and v become float32, as in JAX), then calls a
`torch.autograd.Function`:

- forward, `linear_attention_kernel`: on CUDA tensors the kernel in
  `csrc/linear_attention.cu` (one launch: a cluster of `cluster_size`
  blocks a clip and head, each over its `rank_rows` of k / v and of q, the
  partials combined in distributed shared memory), on CPU tensors its
  plain version
  `linear_attention_plain`, the kernel's math: q softmaxed within each
  head's Dh features, k over time, KV = k_sm^T v per head, y = q_sm KV,
  float32 throughout from the inputs, y in q's dtype;
- backward: autograd of `linear_attention_plain`, recomputed from the saved
  q, k and v.  The JAX custom_vjp differentiates its XLA formulation in the
  inputs' dtypes and has no backward kernel, so neither has the port.  (The
  JAX backward raises on the mixed dtypes a float32 mask gives, bf16 q with
  float32 k and v: its VJP is handed a bf16 cotangent for a float32
  output.  The plain formula's float32 gradients, cast to each input's
  dtype, have no such case.)
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def linear_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """q (B, Tq, D), k and v (B, Tk, D), any float dtypes -> y (B, Tq, D)
    in q's dtype, computed in float32."""
    b, tq, d = q.shape
    dh = d // num_heads
    qs = torch.softmax(q.float().reshape(b, tq, num_heads, dh), dim=-1)
    ks = torch.softmax(k.float().reshape(b, -1, num_heads, dh), dim=1)
    kv = torch.einsum("bnhd,bnhl->bhdl", ks, v.float().reshape(b, -1, num_heads, dh))
    return torch.einsum("bnhd,bhdl->bnhl", qs, kv).reshape(b, tq, d).to(q.dtype)


HEAD_DIM = 16         # the flagship's head width: D = 128 with 8 heads
HEAD_DIMS = (8, 16, 32, 64)  # the head widths the kernel is built for (its template kDh)
CLUSTERS = (8, 2)     # the kernel's cluster sizes, blocks a (clip, head)
# resident blocks an SM its launch bounds ask for at each head width
# (kMinBlocks): a thread keeps a row of Dh sums, and at 32 and 64 more
# registers than 4 blocks leave; BLOCKS_PER_SM at the flagship's
HEAD_BLOCKS_PER_SM = {8: 4, 16: 4, 32: 2, 64: 1}
BLOCKS_PER_SM = HEAD_BLOCKS_PER_SM[HEAD_DIM]
THREADS = 256         # threads a block (kThreads)
H100_SMS = _build.H100_SMS
_DTYPES = (torch.bfloat16, torch.float32)


def cluster_size(batch: int, num_heads: int, sms: int = H100_SMS,
                 head_dim: int = HEAD_DIM) -> int:
    """The blocks a cluster gives each (clip, head): the most of `CLUSTERS`
    that keeps the grid within one wave of resident blocks at
    ``head_dim``'s `HEAD_BLOCKS_PER_SM`, else the least (8 at plain-layer
    serving's B = 2, 2 at the reference-mask step's B = 32)."""
    slots = sms * HEAD_BLOCKS_PER_SM[head_dim]
    return next((s for s in CLUSTERS if batch * num_heads * s <= slots), CLUSTERS[-1])


def plan(head_dim: int, q_dtype: torch.dtype, kv_dtype: torch.dtype) -> dict[str, int]:
    """The launch's shape at ``head_dim`` for q and k / v of these dtypes,
    as `csrc/linear_attention.cu` builds it (its `linear_attention_plan`
    export gives the same): `THREADS` threads; dynamic shared bytes for a
    chunk of k and v rows (``chunk`` = 4096 / Dh rows; after the last one,
    the strips' partials) and the first `THREADS` q rows; static shared
    bytes for the block's partial (m, s and the Dh x Dh sums) and KV; the
    blocks an SM its launch bounds ask for.  The grid is (cluster, H, B)."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"linear_attention: the kernel takes head widths {HEAD_DIMS}, "
                         f"got {head_dim}")
    chunk, strips = 4096 // head_dim, THREADS // head_dim
    stage = max(2 * chunk * head_dim * kv_dtype.itemsize, strips * head_dim * (2 + head_dim) * 4)
    return {"threads": THREADS, "smem": stage + THREADS * head_dim * q_dtype.itemsize,
            "static_smem": (2 * head_dim + 2 * head_dim * head_dim) * 4, "chunk": chunk,
            "blocks_per_sm": HEAD_BLOCKS_PER_SM[head_dim]}


def kernel_plan(head_dim: int, q_dtype: torch.dtype, kv_dtype: torch.dtype) -> dict[str, int]:
    """`plan` as the built kernel reports it (`linear_attention_plan`)."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().linear_attention_plan(
        head_dim, int(q_dtype == torch.bfloat16), int(kv_dtype == torch.bfloat16), out),
        "linear_attention_plan")
    return dict(zip(plan(head_dim, q_dtype, kv_dtype), out))


def rank_rows(t: int, ranks: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) of ``t`` that each block of a cluster of ``ranks``
    owns, as the kernel splits k / v and, apart, q: ceil(t / ranks) a rank,
    fewer in the last, none in a rank past the end."""
    per = -(-t // ranks)
    return [(min(t, r * per), min(t, r * per + per)) for r in range(ranks)]


def linear_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """`linear_attention_plain`'s function; on a CUDA tensor the kernel,
    one launch, which takes contiguous, 16-byte aligned q (B, Tq, D) and
    k, v (B, Tk, D), each bf16 or float32 (k and v of one dtype), with
    D / num_heads in `HEAD_DIMS`, and raises on anything else."""
    if not q.is_cuda:
        return linear_attention_plain(q, k, v, num_heads)
    b, tq, d = q.shape
    tk = k.shape[1]
    dh = d // num_heads
    if (q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype
            or d != num_heads * dh or dh not in HEAD_DIMS):
        raise ValueError(f"linear_attention: the kernel takes bf16 or float32 q and k = v dtypes "
                         f"and D = Dh * num_heads with Dh in {HEAD_DIMS}; got q {q.dtype}, "
                         f"k {k.dtype}, v {v.dtype}, D {d}, {num_heads} heads")
    _build.require(q, "q", q.dtype, (b, tq, d))
    _build.require(k, "k", k.dtype, (b, tk, d))
    _build.require(v, "v", k.dtype, (b, tk, d))
    _build.require_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    err = _build.library().linear_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq, tk, num_heads, dh,
        cluster_size(b, num_heads, _build.sm_count(q.device.index), dh),
        int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), _build.stream())
    _build.check(err, "linear_attention_forward")
    linear_attention_kernel.launches += 1
    return out


linear_attention_kernel.launches = 0


class _LinearAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return linear_attention_kernel(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, dy):
        inputs = [a.detach().requires_grad_(True) for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = linear_attention_plain(*inputs, ctx.num_heads)
            return (*torch.autograd.grad(out, inputs, dy), None)


def fold_key_mask(k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor | None):
    """The reference's key mask (B, Tk, 1) folded into k and v: -1e6 added
    to masked keys, masked values zeroed (with torch's, and JAX's, type
    promotion)."""
    if key_mask is None:
        return k, v
    return k + (1.0 - key_mask) * -1000000.0, v * key_mask


def fused_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v (B, T, D) pre-softmax projections; ``key_mask`` (B, Tk, 1)
    as the reference's additive -1e6 on keys and multiplicative on values.
    Returns (B, Tq, D) in q's dtype."""
    return _LinearAttention.apply(q, *fold_key_mask(k, v, key_mask), num_heads)
