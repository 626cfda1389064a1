"""Context (sequence) parallelism for linear attention: the counterpart of
`conductor_tpu/parallel/context.py:28-64`.

The only cross-frame interactions of linear attention are the keys' time
softmax (a maximum and a sum over T) and the K^T V contraction (a sum over
T), so a T-sharded layout needs one all-reduce MAX and two all-reduce SUMs
an attention; q's rows never leave their rank.  This is plain torch, as
JAX's is plain jnp: the building block of a time-sharded step, which no
CLI reaches yet (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group on every rank; its gradient is the
    sum of the ranks' gradients of y (each rank's loss depends on y)."""

    @staticmethod
    def forward(ctx, x, group, host):
        ctx.group, ctx.host = group, host
        return _all_reduce(x, dist.ReduceOp.SUM, group, host)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group, ctx.host), None, None


def _all_reduce(x: torch.Tensor, op, group, host: bool) -> torch.Tensor:
    """``x`` reduced over the group, on ``x``'s device: through the host
    under gloo (``host``), through this rank's card under NCCL."""
    y = x.detach()
    if host:
        y = y.cpu()
    elif not y.is_cuda:
        y = y.to(torch.device("cuda", torch.cuda.current_device()))
    y = y.clone()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def cp_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        key_mask: torch.Tensor | None = None, group=None) -> torch.Tensor:
    """Linear attention over a T-sharded sequence, called on every rank of
    ``group`` (the default group if None) with its time shard.

    q, k, v: (B, T_local, D); ``key_mask`` (B, T_local, 1) 0/1, whose
    masked keys get -1e6 and masked values 0, as JAX's.  The keys' softmax
    is normalized over the global time axis (the maximum by an all-reduce
    MAX, detached, since the softmax does not move under a shift; the sum
    of exponentials by an all-reduce SUM), and the (B, H, Dh, Dh) K^T V
    state is all-reduce SUMmed; both sums carry gradients.  Returns this
    rank's (B, T_local, D) rows of the output."""
    host = dist.get_backend(group) == "gloo"
    if key_mask is not None:
        k = k + (1.0 - key_mask) * -1000000.0
        v = v * key_mask
    b, t_local, d = q.shape
    h = num_heads
    dh = d // h
    kh = k.reshape(b, t_local, h, dh)
    vh = v.reshape(b, t_local, h, dh)
    kmax = _all_reduce(kh.amax(dim=1, keepdim=True), dist.ReduceOp.MAX, group, host)
    ke = torch.exp(kh - kmax)
    ksum = _AllReduceSum.apply(ke.sum(dim=1, keepdim=True), group, host)
    k_sm = ke / ksum
    kv = _AllReduceSum.apply(torch.einsum("bnhd,bnhl->bhdl", k_sm, vh), group, host)
    qh = torch.softmax(q.reshape(b, t_local, h, dh), dim=-1)
    return torch.einsum("bnhd,bhdl->bnhl", qh, kv).reshape(b, t_local, d)
