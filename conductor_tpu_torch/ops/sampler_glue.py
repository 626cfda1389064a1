"""Sampler glue kernels around the decoder stack (K2, K3), plus their plain
PyTorch versions and the DDIM affine tables.

Port of `conductor_tpu/ops/pallas_sampler.py`:

- `ddim_affine_tables` (`:41-55`): per-step (alpha, beta) with
  x_{t-1} = alpha * x0 + beta * x_t, the eta=0 DDIM update under START_X
  folded into two scalars (numpy, from the float32 schedule tables, as in
  the JAX package);
- `sampler_prologue` (K2, `:80-126`): emb_act = silu(temb[t] + emb_base) and
  h0 = x @ W_joint + seq_bias.  The add of the time-embedding row, which the
  JAX path does just outside its kernel, is fused in.  emb_act leaves in
  ``emb_dtype``, bf16 or float32 (the float32 mode), or with
  ``quantize_emb`` (the int8-AdaLN mode) as int8 codes and float32 row
  scales (`emb_activation`, `:58-72`);
- `sampler_epilogue` (K3, `:143-174`): x0 = h @ W_out + b_out and the DDIM
  update.

The pose stays 26 wide (no 128-lane padding).  A CPU tensor goes to the
plain version, a CUDA tensor to the kernel in `csrc/sampler_glue.cu`: K2 a
warp a row, each warp streaming its rows through a ring of `PRO_STAGES`
shared-memory slots by cp.async; K3 a warp a run of rows, streamed `EPI_GROUP`
at a time through a ring of `EPI_STAGES` slots, lane c keeping W_out's
column c in registers.  Matmul operands are rounded to bf16 with
``mxu_dtype=torch.bfloat16``; with float32 they stay float32 (K3's float32
mode, counted apart in ``launches_f32``, as K2's float32 emb_act is, and
K2's int8 output beside float32 products in ``launches_f32_int8``).
`plan` computes the tiling each launch picks (the kernel's `sampler_plan`
reports the same, `kernel_plan`), `prologue_rows` / `epilogue_outputs` the
rows and outputs each block, warp and thread takes.  `ladder_glue` checks a
ladder's operands once and launches both without the wrappers' checks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .conv_block import _q
from .decoder_stack import quantize_rows

# csrc/sampler_glue.cu's constants
WIDTH = 128             # the flagship's D (the kernels' template width W: any of WIDTHS)
WIDTHS = _build.WIDTHS  # the widths D of h the kernels are built for
POSE = 26               # K3's column count (kPose), the pose width
PRO_WARPS = 8           # K2's warps a block (kProWarps)
PRO_BLOCKS_PER_SM = 3   # K2's launch bounds (kProBlocksPerSm)
PRO_STAGES = 2          # K2: a warp's ring of row slots (kProStages)
POSE_SLOT = 32          # K2: floats a slot keeps for the pose row, C <= 32 (kPoseSlot)
MAX_EV = 4              # K2: emb_base's 16-byte pieces a lane, E <= 512 (kMaxEv)
EPI_WARPS = 4           # K3: warps a block (kEpiWarps)
EPI_BLOCKS_PER_SM = 2   # K3's launch bounds (kEpiBlocksPerSm)
EPI_GROUP = 4           # K3: rows whose chains a lane runs at once (kEpiGroup)
EPI_MAX_GROUPS = 8      # K3: row groups a warp at most (kEpiMaxGroups)
EPI_STAGES = 2          # K3: a warp's ring of row groups (kEpiStages)
# what `kernel_plan` reports, under `plan`'s names
KERNEL_PLAN_KEYS = ("rows", "blocks", "threads", "stages", "smem_bytes")


def plan(b: int, t: int, which: str, *, c: int = POSE, e: int = 512, d: int = WIDTH,
         sms: int = _build.H100_SMS) -> dict:
    """The tiling K2 (``which="prologue"``) or K3 (``"epilogue"``) picks for
    B x T rows of width ``d`` on a card of ``sms`` SMs: ``rows`` a block, ``blocks``,
    ``threads`` a block, ``stages`` (K2: a warp's ring of row slots; K3
    stages its tile once) and ``smem_bytes`` a block.  K2 fills
    `PRO_BLOCKS_PER_SM` blocks an SM (fewer where a warp would have no row)
    and splits the rows evenly over them; K3 gives each warp `EPI_GROUP`
    rows a group, enough groups (up to `EPI_MAX_GROUPS`) that the warp
    slots of `EPI_BLOCKS_PER_SM` blocks an SM share the rows about evenly.
    The rows of one K2 block, or the outputs of one K3 lane, are
    `prologue_rows` / `epilogue_outputs`."""
    n = b * t
    if which == "prologue":
        blocks = min(-(-n // PRO_WARPS), sms * PRO_BLOCKS_PER_SM)
        rows = -(-n // blocks)
        return {"rows": rows, "blocks": -(-n // rows), "threads": PRO_WARPS * 32,
                "stages": PRO_STAGES,
                "smem_bytes": (c * d + PRO_WARPS * PRO_STAGES * (e + POSE_SLOT + d)) * 4}
    if which == "epilogue":
        slots = sms * EPI_BLOCKS_PER_SM * EPI_WARPS
        rows = EPI_WARPS * EPI_GROUP * min(-(-n // (EPI_GROUP * slots)), EPI_MAX_GROUPS)
        return {"rows": rows, "blocks": -(-n // rows), "threads": EPI_WARPS * 32,
                "stages": EPI_STAGES,
                "smem_bytes": (d * c + EPI_WARPS * EPI_STAGES * EPI_GROUP * d) * 4}
    raise ValueError(f"which is 'prologue' or 'epilogue', got {which!r}")


def prologue_rows(p: dict, n_rows: int):
    """(block, warp, row) for each row K2 works on under plan ``p``, in each
    warp's order: block k owns rows [k rows, (k + 1) rows), warp w of it
    takes the w-th, then every `PRO_WARPS`-th, as the kernel walks them."""
    for k in range(p["blocks"]):
        lo, hi = k * p["rows"], min(n_rows, (k + 1) * p["rows"])
        for w in range(PRO_WARPS):
            for row in range(lo + w, hi, PRO_WARPS):
                yield k, w, row


def epilogue_outputs(p: dict, n_rows: int, c: int = POSE):
    """(block, warp, lane, row, column) for each output K3 computes under
    plan ``p``: block k's warp w owns the rows a warp, ``rows`` /
    `EPI_WARPS`, from (k EPI_WARPS + w) times that, and lane l < C column l
    of each of them."""
    warp_rows = p["rows"] // EPI_WARPS
    for k in range(p["blocks"]):
        for w in range(EPI_WARPS):
            lo = (k * EPI_WARPS + w) * warp_rows
            for row in range(lo, min(n_rows, lo + warp_rows)):
                for lane in range(c):
                    yield k, w, lane, row, lane


def kernel_plan(b: int, t: int, which: str, *, c: int = POSE, e: int = 512,
                d: int = WIDTH) -> dict:
    """What K2's or K3's launch for B x T rows of width ``d`` picks on the
    current card (`csrc/sampler_glue.cu` `sampler_plan`, from the kernel's
    own formulas), under `plan`'s names ``KERNEL_PLAN_KEYS``; needs the
    built library."""
    out = (ctypes.c_int * 5)()
    err = _build.library().sampler_plan(b, t, c, d, e, ("prologue", "epilogue").index(which), out)
    _build.check(err, "sampler_plan")
    return dict(zip(KERNEL_PLAN_KEYS, out))


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


def _check_prologue(x, temb, emb_base, w_joint, seq_bias, *, mxu_dtype, emb_dtype,
                    quantize_emb) -> None:
    """Raise unless K2 takes these CUDA operands (`sampler_prologue`)."""
    b, t, c = x.shape
    e, d = emb_base.shape[-1], w_joint.shape[-1]
    if (emb_dtype not in (torch.bfloat16, torch.float32) and not quantize_emb) or mxu_dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError("sampler_prologue kernel writes bf16, float32 or int8 emb_act; mxu_dtype "
                         "bf16 or f32")
    if d not in WIDTHS or not 1 <= c <= POSE_SLOT or e % 128 or not 128 <= e <= 128 * MAX_EV:
        raise ValueError(f"sampler_prologue kernel takes D in {WIDTHS}, C <= {POSE_SLOT} and E "
                         f"a multiple of 128 up to {128 * MAX_EV}; got D={d}, C={c}, E={e}")
    f32 = torch.float32
    _build.require(x, "x", f32, (b, t, c))
    _build.require(temb, "temb", f32, (e,))
    _build.require(emb_base, "emb_base", f32, (b, t, e))
    _build.require(w_joint, "w_joint", f32, (c, d))
    if seq_bias.shape[0] < t:
        raise ValueError(f"seq_bias has {seq_bias.shape[0]} rows for T={t}")
    _build.require(seq_bias, "seq_bias", f32, (seq_bias.shape[0], d))
    _build.require_aligned(temb=temb, emb_base=emb_base, w_joint=w_joint, seq_bias=seq_bias)


def _prologue_launch(x, temb, emb_base, w_joint, seq_bias, rnd: int, quantize_emb: bool,
                     emb_dtype: torch.dtype):
    """K2 on operands `_check_prologue` has passed: one launch."""
    b, t, c = x.shape
    e, d = emb_base.shape[-1], w_joint.shape[-1]
    emb_f32 = not quantize_emb and emb_dtype == torch.float32
    h = torch.empty((b, t, d), dtype=torch.float32, device=x.device)
    emb_act = torch.empty((b, t, e), dtype=torch.int8 if quantize_emb else emb_dtype,
                          device=x.device)
    emb_scale = (torch.empty((b, t, 1), dtype=torch.float32, device=x.device) if quantize_emb
                 else None)
    err = _build.library().sampler_prologue_forward(
        x.data_ptr(), temb.data_ptr(), emb_base.data_ptr(), w_joint.data_ptr(),
        seq_bias.data_ptr(), h.data_ptr(), emb_act.data_ptr(),
        emb_scale.data_ptr() if quantize_emb else None, b, t, c, d, e, rnd, int(emb_f32),
        _build.stream(),
    )
    _build.check(err, "sampler_prologue_forward")
    if quantize_emb and not rnd:
        sampler_prologue.launches_f32_int8 += 1
    elif quantize_emb:
        sampler_prologue.launches_int8 += 1
    elif emb_f32:
        sampler_prologue.launches_f32 += 1
    else:
        sampler_prologue.launches += 1
    return h, emb_act, emb_scale


def sampler_prologue(x, temb, emb_base, w_joint, seq_bias, *,
                     mxu_dtype=torch.float32, emb_dtype=torch.float32, quantize_emb: bool = False):
    """x (B, T, C) pose, temb (E,) the step's time-embedding row, emb_base
    (B, T, E), w_joint (C, D), seq_bias (>= T, D) = seq_emb + b_joint ->
    (h (B, T, D) float32, emb_act (B, T, E) ``emb_dtype``, None), or with
    ``quantize_emb`` (h, emb_q (B, T, E) int8, emb_scale (B, T, 1)
    float32).  One launch, tiled as `plan` says; on CUDA ``emb_dtype`` is
    bf16 or float32."""
    if not x.is_cuda:
        return sampler_prologue_plain(x, temb, emb_base, w_joint, seq_bias, mxu_dtype=mxu_dtype,
                                      emb_dtype=emb_dtype, quantize_emb=quantize_emb)
    _check_prologue(x, temb, emb_base, w_joint, seq_bias, mxu_dtype=mxu_dtype,
                    emb_dtype=emb_dtype, quantize_emb=quantize_emb)
    return _prologue_launch(x, temb, emb_base, w_joint, seq_bias,
                            int(mxu_dtype == torch.bfloat16), quantize_emb, emb_dtype)


def sampler_epilogue_plain(h, x_t, w_out, b_out, alpha, beta, *, mxu_dtype=torch.float32):
    x0 = _q(h, mxu_dtype) @ _q(w_out, mxu_dtype) + b_out
    return alpha * x0 + beta * x_t


def _check_epilogue(x_t, w_out, b_out, *, mxu_dtype) -> None:
    """Raise unless K3 takes these CUDA operands beside an h of x_t's (B, T)
    (`sampler_epilogue` checks h itself)."""
    b, t, c = x_t.shape
    d = w_out.shape[0]
    if mxu_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"sampler_epilogue kernel: mxu_dtype bf16 or f32, got {mxu_dtype}")
    if c != POSE or d not in WIDTHS:
        raise ValueError(f"sampler_epilogue kernel takes C = {POSE} and D in {WIDTHS}; got "
                         f"C={c}, D={d}")
    f32 = torch.float32
    _build.require(x_t, "x_t", f32, (b, t, c))
    _build.require(w_out, "w_out", f32, (d, c))
    _build.require(b_out, "b_out", f32, (c,))
    _build.require_aligned(w_out=w_out)


def _epilogue_launch(h, x_t, w_out, b_out, alpha: float, beta: float, rnd: int):
    """K3 on operands `_check_epilogue` has passed: one launch."""
    b, t, d = h.shape
    out = torch.empty_like(x_t)
    err = _build.library().sampler_epilogue_forward(
        h.data_ptr(), x_t.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(),
        alpha, beta, b, t, d, POSE, rnd, _build.stream(),
    )
    _build.check(err, "sampler_epilogue_forward")
    if rnd:
        sampler_epilogue.launches += 1
    else:
        sampler_epilogue.launches_f32 += 1
    return out


def sampler_epilogue(h, x_t, w_out, b_out, alpha: float, beta: float, *,
                     mxu_dtype=torch.float32):
    """h (B, T, D), x_t (B, T, C), w_out (D, C), b_out (C,) ->
    x_{t-1} = alpha * (h @ w_out + b_out) + beta * x_t, float32.  One
    launch, tiled as `plan` says."""
    alpha, beta = float(alpha), float(beta)
    if not h.is_cuda:
        return sampler_epilogue_plain(h, x_t, w_out, b_out, alpha, beta, mxu_dtype=mxu_dtype)
    _build.require(h, "h", torch.float32, (*x_t.shape[:2], w_out.shape[0]))
    _build.require_aligned(h=h)
    _check_epilogue(x_t, w_out, b_out, mxu_dtype=mxu_dtype)
    return _epilogue_launch(h, x_t, w_out, b_out, alpha, beta, int(mxu_dtype == torch.bfloat16))


def ladder_glue(x, temb_table, emb_base, w_joint, seq_bias, w_out, b_out, *,
                mxu_dtype=torch.float32, quantize_emb: bool = False):
    """K2 and K3 for a whole DDIM ladder on x_T = ``x`` (B, T, C):
    (prologue(x, temb_row), epilogue(h, x_t, alpha, beta)), which compute
    `sampler_prologue` (emb_act in ``mxu_dtype``, or int8 with
    ``quantize_emb``) and `sampler_epilogue` on these weights.  On CUDA the
    operands are checked here, once, as each wrapper would check them every
    step (a step's x and h are the kernels' own outputs, K3's and K1's, its
    temb a row of the checked ``temb_table``), and the two launch without
    the checks, which cost more host time than the kernels take on the
    card."""
    if not x.is_cuda:
        kw = dict(mxu_dtype=mxu_dtype, emb_dtype=mxu_dtype, quantize_emb=quantize_emb)
        return (lambda x_t, temb: sampler_prologue(x_t, temb, emb_base, w_joint, seq_bias, **kw),
                lambda h, x_t, a, b: sampler_epilogue(h, x_t, w_out, b_out, a, b,
                                                      mxu_dtype=mxu_dtype))
    _build.require(temb_table, "temb_table", torch.float32,
                   (temb_table.shape[0], emb_base.shape[-1]))
    _check_prologue(x, temb_table[0], emb_base, w_joint, seq_bias, mxu_dtype=mxu_dtype,
                    emb_dtype=mxu_dtype, quantize_emb=quantize_emb)
    _check_epilogue(x, w_out, b_out, mxu_dtype=mxu_dtype)
    rnd = int(mxu_dtype == torch.bfloat16)
    return (lambda x_t, temb: _prologue_launch(x_t, temb, emb_base, w_joint, seq_bias, rnd,
                                               quantize_emb, mxu_dtype),
            lambda h, x_t, a, b: _epilogue_launch(h, x_t, w_out, b_out, float(a), float(b), rnd))


sampler_prologue.launches = 0
sampler_prologue.launches_int8 = 0
sampler_prologue.launches_f32 = 0
sampler_prologue.launches_f32_int8 = 0
sampler_epilogue.launches = 0
sampler_epilogue.launches_f32 = 0
