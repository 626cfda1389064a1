"""All decoder layers of one denoiser step (K1), plus the plain PyTorch
version.

Port of `conductor_tpu/ops/pallas_layer.py::fused_decoder_stack` and its
layer body `_layer_body` (`:60-160`).  Each layer:

    mod = emb_act @ W_adaln + b_adaln               (the layer's 3 AdaLN pairs)
    self-attention: LN -> q, k, v; q softmaxed over each head's features,
        k over the whole clip (time), KV = k_sm^T v in float32, block-
        diagonal per head; y = q_sm @ KV; x += styl(y)
    cross-attention: LN -> q; y = q_sm @ KV_cross; x += styl(y)
    FFN: tanh-GELU; x += styl(y)
    styl(y) = silu(LN(y) * (1 + scale) + shift) @ W + b

Matmul operands are rounded to ``mxu_dtype`` with float32 products; the
time softmax, KV, LayerNorm statistics, the residual carry and all
elementwise work stay float32, as in the JAX kernel.  The bf16-VPU and
int8-AdaLN modes of the JAX kernel are not ported yet.

Weight banks as `train/fused_denoiser.pack_layer_weights` packs them:
mats (L, 9, D, D), vecs (L, 24, D), adaln_w (L, E, 6D), adaln_b (L, 6D),
kv_cross (L, B, D, D) block-diagonal.  A CPU tensor goes to the plain
version, a CUDA tensor to the kernel in `csrc/decoder_stack.cu`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .conv_block import _q

ROWS_PER_TILE = 64  # the kernel's row tile (csrc/decoder_stack.cu kTileRows)


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def decoder_stack_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                        mxu_dtype=torch.float32, t_valid: int | None = None):
    """The plain version of the kernel: same arguments, same result.  Rows
    at or past ``t_valid`` (default: all rows valid) get the TPU kernel's
    mask: a -1e6 key and a zero value, so they drop out of the time
    softmax and KV."""
    d = x.shape[-1]
    valid = None
    if t_valid is not None and t_valid < x.shape[1]:
        valid = (torch.arange(x.shape[1], device=x.device) < t_valid)[None, :, None]
    head = torch.arange(d, device=x.device) // (d // num_heads)
    seg = (head[:, None] == head[None, :]).float()

    def md(a, w):
        return _q(a, mxu_dtype) @ _q(w, mxu_dtype)

    def seg_softmax(q):
        qe = torch.exp(q - q.amax(-1, keepdim=True))
        return qe / md(qe, seg)

    def styl(y, mod, j, v, w, gi):
        scale, shift = mod[..., 2 * j * d:(2 * j + 1) * d], mod[..., (2 * j + 1) * d:(2 * j + 2) * d]
        h = _ln(y, v[gi], v[gi + 1]) * (1.0 + scale) + shift
        h = h / (1.0 + torch.exp(-h))
        return md(h, w) + v[gi + 2]

    x = x.float()
    for layer in range(mats.shape[0]):
        m, v = mats[layer], vecs[layer].float()
        mod = md(emb_act, adaln_w[layer]) + adaln_b[layer].float()
        # self attention; the time softmax and KV stay float32
        xn = _ln(x, v[0], v[1])
        q, k, val = md(xn, m[0]) + v[2], md(xn, m[1]) + v[3], md(xn, m[2]) + v[4]
        if valid is not None:
            k = torch.where(valid, k, -1e6)
            val = torch.where(valid, val, 0.0)
        ke = torch.exp(k - k.amax(1, keepdim=True))
        kv = torch.einsum("btd,btl->bdl", ke / ke.sum(1, keepdim=True), val) * seg
        x = x + styl(md(seg_softmax(q), kv), mod, 0, v, m[3], 5)
        # cross attention against the precomputed KV state
        qc = md(_ln(x, v[8], v[9]), m[4]) + v[10]
        x = x + styl(md(seg_softmax(qc), kv_cross[layer]), mod, 1, v, m[5], 11)
        # FFN
        h1 = F.gelu(md(x, m[6]) + v[14], approximate="tanh")
        x = x + styl(md(h1, m[7]) + v[15], mod, 2, v, m[8], 16)
    return x


def fused_decoder_stack(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                        mxu_dtype=torch.float32):
    """x (B, T, D) float32, emb_act (B, T, E) -> (B, T, D) float32."""
    if not x.is_cuda:
        return decoder_stack_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b,
                                   num_heads, mxu_dtype=mxu_dtype)
    b, t, d = x.shape
    n_layers, e = mats.shape[0], emb_act.shape[-1]
    dh = d // num_heads
    if mxu_dtype != torch.bfloat16 or d != 128 or e % 16 or 32 % dh or dh * num_heads != d:
        raise ValueError(
            f"decoder_stack kernel takes bf16 operands, D = 128, E % 16 == 0 and a head "
            f"width dividing 32; got {mxu_dtype}, D={d}, E={e}, H={num_heads}"
        )
    bf, f32 = torch.bfloat16, torch.float32
    _build.require(x, "x", f32, (b, t, d))
    _build.require(emb_act, "emb_act", bf, (b, t, e))
    _build.require(kv_cross, "kv_cross", bf, (n_layers, b, d, d))
    _build.require(mats, "mats", bf, (n_layers, 9, d, d))
    _build.require(vecs, "vecs", f32, (n_layers, 24, d))
    _build.require(adaln_w, "adaln_w", bf, (n_layers, e, 6 * d))
    _build.require(adaln_b, "adaln_b", f32, (n_layers, 6 * d))
    n_tiles = -(-t // ROWS_PER_TILE)
    out = torch.empty_like(x)
    partials = torch.empty((b, n_tiles, 2 * d + d * dh), dtype=f32, device=x.device)
    kv_self = torch.empty((b, d, d), dtype=bf, device=x.device)
    err = _build.library().decoder_stack_forward(
        x.data_ptr(), emb_act.data_ptr(), kv_cross.data_ptr(), mats.data_ptr(),
        vecs.data_ptr(), adaln_w.data_ptr(), adaln_b.data_ptr(), out.data_ptr(),
        partials.data_ptr(), kv_self.data_ptr(), b, t, d, e, num_heads, n_layers,
        _build.stream(),
    )
    _build.check(err, "decoder_stack_forward")
    fused_decoder_stack.launches += 1
    return out


fused_decoder_stack.launches = 0
