"""K8's split-and-combine rule on the CPU: a numpy float32 emulation of what
`csrc/linear_attention.cu` computes, against the JAX package's
`fused_linear_attention` (Pallas in interpret mode, as
tests/test_torch_port_attention.py runs it) and the port's plain version.

The kernel gives each (clip, head) a cluster of S blocks (S in
`CLUSTERS`, `cluster_size` picks it per call).  Rank s owns the k / v rows
of `rank_rows(Tk, S)` and, apart, the q rows of `rank_rows(Tq, S)`.  A
block stages its k / v rows `CHUNK` at a time; thread (p, i) keeps, for
column i over rows p, p + 16, ... of each chunk, a running max m, the sum
s of exp(k - m) and the row exp(k - m) v, rescaled when a chunk raises m.
The 16 strips, then the ranks, are combined in order, each rescaled by
exp(m - max m) (weight 0 for a part without rows); KV = sum / s.  The
emulation follows those steps in float32 for every S.  The card's
exponential and fused multiply-adds round otherwise; the 1e-5 bound here
is the JAX kernel's own against its XLA formulation, and the card's
output is held to its plain version there (`tests/test_torch_port_cuda.py`,
`chip_smoke.py`).  Also: each row lies in exactly one rank, for T below
and above the cluster's size, and `cluster_size` keeps the grid within one
wave of an H100's resident blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.ops.pallas_attention import fused_linear_attention as jax_fused
from conductor_tpu_torch.ops.attention import (
    BLOCKS_PER_SM,
    CLUSTERS,
    H100_SMS,
    HEAD_DIM,
    cluster_size,
    fused_linear_attention,
    rank_rows,
)

STRIPS = 16  # the kernel's kStrips
CHUNK = 256  # the kernel's kChunk


def _combine(parts):
    """Parts (m, s, acc) over disjoint rows -> one, rescaled to the
    columns' common max in the parts' order (weight 0 where m = -inf)."""
    big = np.max([m for m, _, _ in parts], axis=0)
    safe = np.where(big == -np.inf, np.float32(0), big)
    s_out = np.zeros_like(parts[0][1])
    acc_out = np.zeros_like(parts[0][2])
    for m, s, acc in parts:
        w = np.exp(np.where(m == -np.inf, -np.inf, m - safe)).astype(np.float32)
        s_out = s_out + s * w
        acc_out = acc_out + acc * w[..., None]
    return big, s_out, acc_out


def _strip(kh, vh, rows_lo, rows_hi, p):
    """Thread (p, .)'s part over rows p, p + 16, ... of each chunk."""
    b, _, h, dh = kh.shape
    m = np.full((b, h, dh), -np.inf, np.float32)
    s = np.zeros((b, h, dh), np.float32)
    acc = np.zeros((b, h, dh, dh), np.float32)
    for c0 in range(rows_lo, rows_hi, CHUNK):
        rows = np.arange(c0 + p, min(rows_hi, c0 + CHUNK), STRIPS)
        if not len(rows):
            continue
        kr = kh[:, rows]
        cm = kr.max(1)
        grow = cm > m
        sc = np.exp(np.where(grow, m - np.where(grow, cm, 0), 0)).astype(np.float32)
        m = np.where(grow, cm, m)
        s, acc = s * sc, acc * sc[..., None]
        e = np.exp(kr - m[:, None]).astype(np.float32)
        s = s + e.sum(1, dtype=np.float32)
        acc = acc + np.einsum("bnhi,bnhj->bhij", e, vh[:, rows]).astype(np.float32)
    return m, s, acc


def emulate(q, k, v, num_heads, cluster):
    """K8's rule in numpy float32 over clusters of ``cluster`` blocks:
    q (B, Tq, D), k, v (B, Tk, D) -> y."""
    b, tq, d = q.shape
    kh = k.reshape(b, -1, num_heads, HEAD_DIM).astype(np.float32)
    vh = v.reshape(b, -1, num_heads, HEAD_DIM).astype(np.float32)
    ranks = [_combine([_strip(kh, vh, lo, hi, p) for p in range(STRIPS)])
             for lo, hi in rank_rows(kh.shape[1], cluster)]
    _, s, acc = _combine(ranks)
    kv = acc / s[..., None]
    x = q.reshape(b, tq, num_heads, HEAD_DIM).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    qs = e / e.sum(-1, keepdims=True)
    return np.einsum("bnhd,bhdl->bnhl", qs, kv).reshape(b, tq, d)


def _inputs(b, tq, tk, seed, lengths=None):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.normal(size=(b, t, 128)).astype(np.float32) for t in (tq, tk, tk))
    mask = None
    if lengths is not None:
        mask = (np.arange(tk)[None] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    return q, k, v, mask


@pytest.mark.parametrize("b,tq,tk,lengths", [
    (1, 900, 900, [60]),      # the reference-mask step's T and m_lens
    (1, 1800, 1800, None),    # the plain-layer serving T
    (2, 5, 5, None),          # T < the cluster's 8 blocks: ranks without rows
    (2, 40, 3, None),         # Tq != Tk, Tk < 8
    (2, 33, 300, [300, 171]),  # Tq != Tk, a ragged mask
    (1, 24, 2100, [1999]),    # a rank's rows in two or more chunks, masked rows in the last
])
def test_split_and_combine_matches_jax_kernel(b, tq, tk, lengths):
    q, k, v, mask = _inputs(b, tq, tk, tq + tk, lengths)
    kf, vf = k, v
    if mask is not None:  # the wrappers' fold: -1e6 on masked keys, masked values zeroed
        kf, vf = k + (1.0 - mask) * np.float32(-1000000.0), v * mask
    want = np.asarray(jax_fused(*(jnp.asarray(a) for a in (q, k, v)), 8,
                                None if mask is None else jnp.asarray(mask)))
    port = fused_linear_attention(*(torch.from_numpy(a) for a in (q, k, v)), 8,
                                  None if mask is None else torch.from_numpy(mask)).numpy()
    for cluster in CLUSTERS:
        got = emulate(q, kf.astype(np.float32), vf.astype(np.float32), 8, cluster)
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, port, atol=1e-5)


@pytest.mark.parametrize("t", [1, 2, 5, 7, 8, 9, 17, 63, 64, 65, 900, 1800, 2100])
def test_rank_rows_hold_each_row_once(t):
    for cluster in CLUSTERS:
        spans = rank_rows(t, cluster)
        assert len(spans) == cluster
        owner = [r for r, (lo, hi) in enumerate(spans) for _ in range(lo, hi)]
        assert len(owner) == t and owner == sorted(owner)  # each row once, in rank order
        assert all(lo <= hi for lo, hi in spans) and spans[0][0] == 0
        assert max(hi - lo for lo, hi in spans) == -(-t // cluster)


def test_cluster_size_fills_one_wave():
    """The serving shape (B = 2, 8 heads) gets the portable maximum, 8
    blocks a clip and head; the reference-mask step's (B = 32) 2; every
    grid fits one wave of resident blocks unless the least cluster size
    already exceeds it, and the next larger size would not fit."""
    assert cluster_size(2, 8) == 8 and cluster_size(32, 8) == 2
    slots = H100_SMS * BLOCKS_PER_SM
    for b in range(1, 300):
        s = cluster_size(b, 8)
        assert s in CLUSTERS and (b * 8 * s <= slots or s == CLUSTERS[-1])
        assert s == CLUSTERS[0] or b * 8 * CLUSTERS[CLUSTERS.index(s) - 1] > slots
