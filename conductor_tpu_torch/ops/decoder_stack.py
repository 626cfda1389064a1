"""All decoder layers of one denoiser step (K1), plus the plain PyTorch
version and `quantize_rows`.

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
elementwise work stay float32, as in the JAX kernel.  Its two opt-in
serving modes:

- int8 AdaLN (``emb_scale`` / ``adaln_w_scale`` given): ``emb_act`` holds
  int8 rows quantized per row (`quantize_rows`, scales (B, T, 1)) and
  ``adaln_w`` int8 columns quantized per column (scales (L, 1, 6D)); the
  modulation is the exact integer product, dequantized as
  ``acc * (emb_scale * adaln_w_scale) + adaln_b`` (`:113-118`);
- bf16 VPU (``vpu_dtype=torch.bfloat16``): the q feature-softmax exp, the
  StylizationBlock SiLU and the FFN GELU run in bf16, every op rounded
  where JAX's `_layer_body` casts to ``vd`` (`:98, 102-105, 154`); LN
  statistics, the time softmax, KV and the residual stay float32.

Matmul operands are bf16 (``mxu_dtype=torch.bfloat16``) or, in the float32
mode (``mxu_dtype=torch.float32``), float32: the matrices, the cross KV,
``emb_act`` and ``adaln_w`` float32 (int8 in the int8-AdaLN mode), KV_self
unrounded; both opt-in modes compose with it.

Weight banks as `train/fused_denoiser.pack_layer_weights` packs them:
mats (L, 9, D, D), vecs (L, 24, D), adaln_w (L, E, 6D), adaln_b (L, 6D),
kv_cross (L, B, D, D) block-diagonal.  A CPU tensor goes to the plain
version, a CUDA tensor to the kernels in `csrc/decoder_stack.cu` (passes A,
B and C of each layer) and `csrc/adaln_gemm.cu` (every layer's AdaLN
modulation, one tensor-core GEMM launched before the first layer;
`adaln_modulation` runs it alone, `adaln_modulation_plain` is its plain
version); in the float32 mode the passes and the GEMM run float32 FFMA on
the CUDA cores.  The kernels take the model widths D in `WIDTHS` (32, 64,
128; one build of the layer sources each) with a head width dividing 32
(`layer_widths_ok`); `plan` and `adaln_plan` give their launches' shapes.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .conv_block import _q

ROWS_PER_TILE = 64  # the kernel's row tile (csrc/decoder_stack.cu kTileRows)
ROWS_TILE_C = 32    # pass C's (and K6's row passes') row tile (csrc/layer_common.cuh kRowsTile)
WIDTHS = _build.WIDTHS  # the model widths D the decoder kernels (K1, K5, K6) are built for
SMEM_LIMIT = 232_448    # the shared bytes a block can have on an H100


def layer_widths_ok(d: int, num_heads: int) -> bool:
    """Whether the decoder kernels (K1 / K5 / K6, and K2 / K3 beside K1)
    take model width ``d`` with ``num_heads`` heads: D in `WIDTHS` and a
    head width dividing 32 (the head sums are shuffles within a warp)."""
    return (d in WIDTHS and 1 <= num_heads <= d and d % num_heads == 0
            and 32 % (d // num_heads) == 0)


def plan(d: int, t: int, t_valid: int | None = None, f32: bool = False) -> dict[str, int]:
    """The launches of one K1 / K5 layer at width ``d`` for clips of ``t``
    rows (``t_valid`` of them in the KV pass), bf16 or float32 (``f32``),
    as `csrc/decoder_stack.cu` makes them (its `decoder_stack_plan_d<D>`
    export gives the same): pass A a thread a column over 64-row tiles, its
    operand, k and v tiles in shared memory (and in the float32 mode a
    whole staged D x D matrix); pass B a block a row of KV; pass C 8 warps
    over 32-row tiles beside a ring of two staged bf16 matrices or three
    32-row float32 k-slabs."""
    if d not in WIDTHS:
        raise ValueError(f"the decoder kernels are built for D in {WIDTHS}, got {d}")
    t_valid = t if t_valid is None else t_valid
    ld_f, ld_a = d + 4, d + 8
    op = ld_f * 4 if f32 else ld_a * 2
    smem_a = ROWS_PER_TILE * (op + 2 * ld_f * 4) + (d * d * 4 if f32 else 0)
    ring = 3 * 32 * d * 4 if f32 else 2 * d * d * 2
    smem_c = ring + ROWS_TILE_C * (2 * ld_f * 4 + op)
    return {"a_threads": d, "a_tiles": -(-t_valid // ROWS_PER_TILE), "a_smem": smem_a,
            "b_threads": d, "b_blocks": d, "c_threads": 256,
            "c_tiles": -(-t // ROWS_TILE_C), "c_smem": smem_c}


def kernel_plan(d: int, t: int, t_valid: int | None = None, f32: bool = False) -> dict[str, int]:
    """`plan` as the built kernel reports it (`decoder_stack_plan_d<D>`)."""
    out = (ctypes.c_int * 8)()
    _build.check(_build.width_entry("decoder_stack_plan", d)(
        t, t if t_valid is None else t_valid, int(f32), out), "decoder_stack_plan")
    return dict(zip(plan(d, t, t_valid, f32), out))


def adaln_plan(m: int, n: int, layers: int, dtype: torch.dtype,
               sms: int = _build.H100_SMS) -> dict[str, int]:
    """The AdaLN GEMM's tiling for ``m`` rows and ``layers`` layers of ``n``
    columns in operand ``dtype``, as `csrc/adaln_gemm.cu` `plan_of` picks
    it: BM 128 while 128-row tiles give every SM one (else 64; float32
    always 128), BN 128 where n is a multiple of 128, else 64 (N = 6D = 192
    at D = 32); 4 warps (float32: 8) a tile, 3 stages of BM + 128 BN bytes
    (float32: static shared memory)."""
    bn = 128 if n % 128 == 0 else 64
    f32 = dtype == torch.float32
    bm = 128 if f32 or -(-m // 128) * (layers * n // bn) >= sms else 64
    return {"bm": bm, "bn": bn, "threads": 256 if f32 else 128, "grid_x": layers * n // bn,
            "grid_y": -(-m // bm), "smem": 0 if f32 else 3 * (bm * 128 + 128 * bn)}


def kernel_adaln_plan(m: int, n: int, layers: int, dtype: torch.dtype) -> dict[str, int]:
    """`adaln_plan` on the current card as the kernel reports it
    (`adaln_gemm_plan`)."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.library().adaln_gemm_plan(m, n, layers, _GEMM_OPERANDS[dtype], out),
                 "adaln_gemm_plan")
    return dict(zip(adaln_plan(m, n, layers, dtype), out))


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last axis, JAX
    `quantize_rows` (`pallas_layer.py:345-354`): ``scale = max(max|x|,
    1e-8) / 127`` in float32 and ``q = round(x / scale)``, half to even, so
    that ``q * scale ~= x``.  Both divisions are true divisions (a CUDA
    division by a host scalar would multiply by its reciprocal)."""
    x = x.float()
    amax = x.abs().amax(-1, keepdim=True).clamp(min=1e-8)
    scale = amax / torch.tensor(127.0, device=x.device)
    return torch.round(x / scale).to(torch.int8), scale


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(approximate=True)` op by op in ``x``'s dtype: its two
    constants and every product and sum rounded to that dtype, in jax's
    order (``x ** 3`` as ``x * (x * x)``)."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    cdf = 0.5 * (1.0 + torch.tanh(c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * (x * x)))))
    return x * cdf


def adaln_modulation_plain(emb_act, adaln_w, adaln_b, *, mxu_dtype=torch.float32,
                           emb_scale=None, adaln_w_scale=None):
    """The AdaLN modulation, JAX `_layer_body` (`pallas_layer.py:112-120`):
    ``emb_act (..., E) @ adaln_w (E, N) + adaln_b (N,)`` in float32, the
    operands rounded to ``mxu_dtype``.  In the int8 mode (``emb_scale``
    (..., 1) and ``adaln_w_scale`` (1, N) given, int8 codes) the integer
    product, as a float32 product of the codes (exact while every partial
    sum is an integer below 2**24, E * 127**2 < 2**24; TF32 must be off),
    dequantized as ``acc * (emb_scale * adaln_w_scale) + adaln_b``, each op
    rounded on its own, in JAX's order.  Stacked layers, ``adaln_w`` (L, E,
    N), ``adaln_b`` (L, N) and ``adaln_w_scale`` (L, 1, N), give (..., L N):
    each layer's N columns in turn."""
    if adaln_w.dim() == 3:
        return torch.cat([adaln_modulation_plain(
            emb_act, adaln_w[i], adaln_b[i], mxu_dtype=mxu_dtype, emb_scale=emb_scale,
            adaln_w_scale=None if adaln_w_scale is None else adaln_w_scale[i])
            for i in range(adaln_w.shape[0])], -1)
    if adaln_w_scale is None:
        return _q(emb_act, mxu_dtype) @ _q(adaln_w, mxu_dtype) + adaln_b.float()
    if emb_act.shape[-1] * 127 ** 2 >= 2 ** 24:
        raise ValueError(f"E = {emb_act.shape[-1]}: the float32 integer product is inexact")
    acc = emb_act.float() @ adaln_w.float()
    return acc * (emb_scale * adaln_w_scale) + adaln_b.float()


# the AdaLN GEMM's operand types (csrc/adaln_gemm.cuh AdalnOperands)
_GEMM_OPERANDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}


def _adaln_widths_ok(e: int, n: int, dtype: torch.dtype) -> bool:
    """The AdaLN GEMM's tiles for its operand ``dtype``: 128 bytes of E a
    stage (64 bf16 or 128 int8 codes), or 8 float32 k-rows a slice; 128 or
    64 columns a tile (csrc/adaln_gemm.cu)."""
    step = {torch.bfloat16: 64, torch.int8: 128, torch.float32: 8}[dtype]
    return e > 0 and e % step == 0 and n > 0 and n % 64 == 0


def adaln_modulation(emb_act, adaln_w, adaln_b, *, mxu_dtype=torch.float32, emb_scale=None,
                     adaln_w_scale=None):
    """The AdaLN modulation of stacked layers, ``emb_act`` (..., E) with
    ``adaln_w`` (L, E, N), ``adaln_b`` (L, N) (and ``adaln_w_scale`` (L, 1,
    N)) -> (..., L N) float32: the plain version on a CPU tensor, on a CUDA
    tensor the GEMM that K1 (all its layers in one launch), K5 and K6 run
    before their row passes (bf16 or float32 operands, or int8 codes with
    their scales; float32 sums and output).  Its launches count in
    ``launches``, those in float32 in ``launches_f32``."""
    int8 = adaln_w_scale is not None
    if (emb_scale is None) == int8:
        raise ValueError("the int8 mode takes both emb_scale and adaln_w_scale")
    if not emb_act.is_cuda:
        return adaln_modulation_plain(emb_act, adaln_w, adaln_b, mxu_dtype=mxu_dtype,
                                      emb_scale=emb_scale, adaln_w_scale=adaln_w_scale)
    n_layers, e, n = adaln_w.shape
    lead = tuple(emb_act.shape[:-1])
    m = math.prod(lead)
    dtype = torch.int8 if int8 else mxu_dtype
    if dtype not in _GEMM_OPERANDS or not _adaln_widths_ok(e, n, dtype) or m < 1:
        raise ValueError(f"the AdaLN kernel takes bf16 or float32 operands (or int8 codes), E a "
                         f"multiple of 64, 8 or 128 and N of 64; got {dtype}, E={e}, N={n}")
    _build.require(emb_act, "emb_act", dtype, (*lead, e))
    _build.require(adaln_w, "adaln_w", dtype, (n_layers, e, n))
    _build.require(adaln_b, "adaln_b", torch.float32, (n_layers, n))
    if int8:
        _build.require(emb_scale, "emb_scale", torch.float32, (*lead, 1))
        _build.require(adaln_w_scale, "adaln_w_scale", torch.float32, (n_layers, 1, n))
    _build.require_aligned(emb_act=emb_act, adaln_w=adaln_w)
    out = torch.empty((*lead, n_layers * n), dtype=torch.float32, device=emb_act.device)
    launches = ctypes.c_int(0)
    err = _build.library().adaln_modulation_forward(
        emb_act.data_ptr(), adaln_w.data_ptr(), emb_scale.data_ptr() if int8 else None,
        adaln_w_scale.data_ptr() if int8 else None, adaln_b.data_ptr(), out.data_ptr(),
        ctypes.addressof(launches), m, e, n, n_layers, _GEMM_OPERANDS[dtype], _build.stream())
    _build.check(err, "adaln_modulation_forward")
    _count_gemm(dtype, launches.value)
    return out


def _count_gemm(dtype: torch.dtype, n: int) -> None:
    if dtype == torch.float32:
        adaln_modulation.launches_f32 += n
    else:
        adaln_modulation.launches += n


# the GEMM's launches, as the C entry points that launch it (this wrapper's,
# K1's, K5's and K6's) report them: bf16 and int8, and float32 apart
adaln_modulation.launches = 0
adaln_modulation.launches_f32 = 0


def decoder_stack_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                        mxu_dtype=torch.float32, vpu_dtype=torch.float32, emb_scale=None,
                        adaln_w_scale=None, t_valid: int | None = None):
    """The plain version of the kernel: same arguments, same result.  Rows
    at or past ``t_valid`` (default: all rows valid) get the TPU kernel's
    mask: a -1e6 key and a zero value, so they drop out of the time
    softmax and KV.  In the int8 mode the integer product is a float32
    product of the codes, exact while every partial sum is an integer below
    2**24 (E * 127**2 < 2**24); TF32 must be off."""
    d = x.shape[-1]
    valid = None
    if t_valid is not None and t_valid < x.shape[1]:
        valid = (torch.arange(x.shape[1], device=x.device) < t_valid)[None, :, None]
    head = torch.arange(d, device=x.device) // (d // num_heads)
    seg = (head[:, None] == head[None, :]).float()
    vd = vpu_dtype

    def md(a, w):
        return _q(a, mxu_dtype) @ _q(w, mxu_dtype)

    def seg_softmax(q):
        qe = torch.exp((q - q.amax(-1, keepdim=True)).to(vd))
        return qe.float() / md(qe, seg)

    def styl(y, mod, j, v, w, gi):
        scale, shift = mod[..., 2 * j * d:(2 * j + 1) * d], mod[..., (2 * j + 1) * d:(2 * j + 2) * d]
        h = (_ln(y, v[gi], v[gi + 1]) * (1.0 + scale) + shift).to(vd)
        h = h / (1.0 + torch.exp(-h))
        return md(h, w) + v[gi + 2]

    def gelu(u):
        return F.gelu(u, approximate="tanh") if vd == torch.float32 else gelu_tanh(u.to(vd))

    x = x.float()
    for layer in range(mats.shape[0]):
        m, v = mats[layer], vecs[layer].float()
        mod = adaln_modulation_plain(
            emb_act, adaln_w[layer], adaln_b[layer], mxu_dtype=mxu_dtype, emb_scale=emb_scale,
            adaln_w_scale=None if adaln_w_scale is None else adaln_w_scale[layer])
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
        h1 = gelu(md(x, m[6]) + v[14])
        x = x + styl(md(h1, m[7]) + v[15], mod, 2, v, m[8], 16)
    return x


def fused_decoder_stack(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads, *,
                        mxu_dtype=torch.float32, vpu_dtype=torch.float32, emb_scale=None,
                        adaln_w_scale=None):
    """x (B, T, D) float32, emb_act (B, T, E) -> (B, T, D) float32.  The
    int8-AdaLN mode takes int8 ``emb_act`` and ``adaln_w`` with their
    ``emb_scale`` (B, T, 1) and ``adaln_w_scale`` (L, 1, 6D).  On CUDA the
    operands are in ``mxu_dtype``, bf16 or float32.  Each launch counts in
    one count of its mode: ``launches`` (bf16 alone), ``launches_int8``
    and ``launches_vpu_bf16`` (both when both are on), and in the float32
    mode ``launches_f32`` (alone), ``launches_f32_int8`` and
    ``launches_f32_vpu_bf16``."""
    int8 = adaln_w_scale is not None
    if (emb_scale is None) == int8:
        raise ValueError("the int8-AdaLN mode takes both emb_scale and adaln_w_scale")
    if vpu_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vpu_dtype is float32 or bfloat16, got {vpu_dtype}")
    if not x.is_cuda:
        return decoder_stack_plain(x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, num_heads,
                                   mxu_dtype=mxu_dtype, vpu_dtype=vpu_dtype, emb_scale=emb_scale,
                                   adaln_w_scale=adaln_w_scale)
    b, t, d = x.shape
    n_layers, e = mats.shape[0], emb_act.shape[-1]
    dh = d // num_heads
    emb_dtype = torch.int8 if int8 else mxu_dtype
    if (mxu_dtype not in (torch.bfloat16, torch.float32) or not layer_widths_ok(d, num_heads)
            or not _adaln_widths_ok(e, 6 * d, emb_dtype)):
        raise ValueError(
            f"decoder_stack kernel takes bf16 or float32 operands, D in {WIDTHS}, E a multiple "
            f"of 64 (bf16), 8 (float32) or 128 (int8) and a head width dividing 32; got "
            f"{mxu_dtype}, D={d}, E={e}, H={num_heads}"
        )
    bf, f32 = torch.bfloat16, torch.float32
    mode_f32 = mxu_dtype == f32
    _build.require(x, "x", f32, (b, t, d))
    _build.require(emb_act, "emb_act", emb_dtype, (b, t, e))
    _build.require(kv_cross, "kv_cross", mxu_dtype, (n_layers, b, d, d))
    _build.require(mats, "mats", mxu_dtype, (n_layers, 9, d, d))
    _build.require(vecs, "vecs", f32, (n_layers, 24, d))
    _build.require(adaln_w, "adaln_w", emb_dtype, (n_layers, e, 6 * d))
    _build.require(adaln_b, "adaln_b", f32, (n_layers, 6 * d))
    if int8:
        _build.require(emb_scale, "emb_scale", f32, (b, t, 1))
        _build.require(adaln_w_scale, "adaln_w_scale", f32, (n_layers, 1, 6 * d))
    _build.require_aligned(emb_act=emb_act, adaln_w=adaln_w, mats=mats, kv_cross=kv_cross)
    n_tiles = -(-t // ROWS_PER_TILE)
    out = torch.empty_like(x)
    partials = torch.empty((b, n_tiles, 2 * d + d * dh), dtype=f32, device=x.device)
    kv_self = torch.empty((b, d, d), dtype=mxu_dtype, device=x.device)
    mod = torch.empty((b * t, n_layers * 6 * d), dtype=f32, device=x.device)  # all layers' AdaLN
    gemm_launches = ctypes.c_int(0)
    err = _build.width_entry("decoder_stack_forward", d)(
        x.data_ptr(), emb_act.data_ptr(), emb_scale.data_ptr() if int8 else None,
        kv_cross.data_ptr(), mats.data_ptr(), vecs.data_ptr(), adaln_w.data_ptr(),
        adaln_w_scale.data_ptr() if int8 else None, adaln_b.data_ptr(), out.data_ptr(),
        partials.data_ptr(), kv_self.data_ptr(), mod.data_ptr(), ctypes.addressof(gemm_launches),
        b, t, d, e, num_heads, n_layers, int(int8), int(vpu_dtype == bf), int(mode_f32),
        _build.stream(),
    )
    _build.check(err, "decoder_stack_forward")
    _count_gemm(emb_dtype, gemm_launches.value)
    # one count per mode: "decoder_stack" the bf16-MMA mode alone, and one
    # each for the int8-AdaLN and bf16-VPU modes (both when both are on);
    # the float32 mode's counts apart
    pre = "launches_f32" if mode_f32 else "launches"
    if int8:
        _bump(f"{pre}_int8")
    if vpu_dtype == bf:
        _bump(f"{pre}_vpu_bf16")
    if not int8 and vpu_dtype != bf:
        _bump(pre)
    return out


def _bump(attr: str) -> None:
    setattr(fused_decoder_stack, attr, getattr(fused_decoder_stack, attr) + 1)


fused_decoder_stack.launches = 0
fused_decoder_stack.launches_int8 = 0
fused_decoder_stack.launches_vpu_bf16 = 0
fused_decoder_stack.launches_f32 = 0
fused_decoder_stack.launches_f32_int8 = 0
fused_decoder_stack.launches_f32_vpu_bf16 = 0
