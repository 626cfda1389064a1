"""The whole frozen ST-GCN as one forward and one d(input) backward (K7).

Port of `conductor_tpu/ops/pallas_stgcn.py::fused_frozen_stgcn` (the
custom_vjp :243-303; forward pallas_call at :252, backward
`_stgcn_vjp_bwd` :275, pallas_call at :280): (B, T, 13, 2) motion -> (B, T,
64) latents of a frozen `MotionEncoderSTGCN`, differentiable with respect
to the motion only.

`pack_frozen_stgcn` folds the module's weights as the JAX pack does
(`pallas_stgcn.py:61-132`): ``data_bn`` into block 0's graph-conv matrix;
adjacency x edge importance x GraphConv weight into one dense (V*Cin, V*C)
matrix per block (the "uniform" partition, K = 1); each BatchNorm's running
statistics into the preceding matmul's scale and bias; ``fc`` + ``fc_bn``
and the channel-major (C, V) flatten into one permuted (416, 64) matrix.
A frame's 13 x 32 values are joint-major (v * 32 + c) and unpadded.

`frozen_stgcn_plain` is the plain version, with the JAX kernel's roundings
(`_md`, :135-137): each matmul's two operands rounded to ``mxu_dtype``,
float32 accumulation, bias, ReLU and residual in float32.  Per block:
g = relu(h M + b1); y = sum_k g[t + k - 1] W_k + b2 (+ h after block 0),
zero-padded at the clip's edges; h = relu(y).

`stgcn_backward_plain` is the plain version of the backward kernel: it
walks the blocks in reverse from the output cotangent and reads nothing of
the forward but its ReLU masks, [g > 0] and [h > 0] of each block, in the
kernels' bit layout (`pack_relu_masks`: one 32-bit word a joint, 13 a
frame), with the same roundings.

`fused_frozen_stgcn` is a `torch.autograd.Function`.  On CPU tensors it
runs the plain version, and its backward is autograd through it.  On CUDA
tensors the forward is `stgcn_forward`, which keeps the masks, and the
backward `stgcn_backward`, which take 13 joints and 32 channels and the
pack in one of two modes, read from its matrices' dtype: bf16, the kernels
in `csrc/stgcn.cu` (one launch a block and direction, tiled as `plan`
reports), or float32, the float32 mode in `csrc/stgcn_f32.cu` (FFMA: a
dense product and a temporal conv a block and direction, and the
projection), counted in ``launches_f32``; anything else raises.  The pack
takes no gradient.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from . import _build
from .conv_block import _q

V, C, BLOCKS, OUT = 13, 32, 10, 64  # joints, channels, st_gcn blocks, latent width
IN = V * 2       # a frame of motion: 13 joints x (x, y)
IN_PAD = 32      # block 0's matrix rows, padded with zeros to a whole 16-deep MMA step
WIDTH = V * C    # 416 values a frame between blocks
PACK_KEYS = ("m0", "m", "wt", "b1", "b2", "fc", "fcb")
# the kernels' tiling: a thread block of WARPS warps, one a joint, one
# block an SM; its tile heights and ring depths are csrc/stgcn.cu's
# (`_tiling`)
WARPS = V
SMEM_PER_SM = 233472     # an H100 SM's shared memory, bytes (1 KB of it reserved a block)
SMEM_PER_BLOCK = 232448  # the most one block can take


def _affine(bn) -> tuple[torch.Tensor, torch.Tensor]:
    """An eval BatchNorm as a per-channel (scale, shift)."""
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return s, bn.bias - bn.running_mean * s


@torch.no_grad()
def pack_frozen_stgcn(model, mxu_dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """A `models.stgcn.MotionEncoderSTGCN` -> its packed weights, on the
    module's device: matrices in ``mxu_dtype``, biases in float32.

    m0 (32, 416): block 0's graph conv with data_bn folded in (rows 26-31
    zero); m (9, 416, 416): blocks 1-9; wt (10, 3, 32, 32): the temporal
    taps (tap, in, out) with their BN folded in; b1 (10, 416), b2 (10, 32):
    the biases after the graph conv and after the temporal conv; fc (416,
    64), fcb (64,): the projection with fc_bn folded in."""
    net = model.st_gcn
    a = net.A.float()
    if a.shape != (1, V, V):
        raise ValueError(f"the pack takes the 'uniform' {V}-joint graph, got A {tuple(a.shape)}")
    mats, b1s, wts, b2s = [], [], [], []
    for i, blk in enumerate(net.st_gcn_networks):
        ae = a[0] * net.edge_importance[i][0].float()                      # (V, V)
        w = blk.gcn.conv.weight[:, :, 0, 0].float()                        # (C, Cin)
        cin = w.shape[1]
        mat = torch.einsum("vw,ci->viwc", ae, w).reshape(V * cin, WIDTH)
        bias = torch.einsum("c,vw->wc", blk.gcn.conv.bias.float(), ae).reshape(WIDTH)
        s1, t1 = _affine(blk.tcn[0])
        mats.append(mat * s1.repeat(V)[None, :])
        b1s.append(bias * s1.repeat(V) + t1.repeat(V))
        s2, t2 = _affine(blk.tcn[3])
        wts.append(blk.tcn[2].weight[:, :, :, 0].permute(2, 1, 0) * s2)  # (3, Cin, C)
        b2s.append(blk.tcn[2].bias * s2 + t2)
    # block 0: x_norm = x * sd + td, so x_norm M0 = x (sd M0) + td M0
    sd, td = _affine(net.data_bn)
    b1s[0] = b1s[0] + td @ mats[0]
    m0 = torch.zeros((IN_PAD, WIDTH), device=a.device)
    m0[:IN] = sd[:, None] * mats[0]
    # fc + fc_bn + the channel-major (C, V) flatten: lane v * C + c reads row c * V + v
    sf, tf = _affine(model.fc[1])
    lane = torch.arange(WIDTH, device=a.device)
    fc = model.fc[0].weight[:, (lane % C) * V + lane // C, 0].t() * sf
    pack = {
        "m0": m0.to(mxu_dtype), "m": torch.stack(mats[1:]).to(mxu_dtype),
        "wt": torch.stack(wts).to(mxu_dtype), "b1": torch.stack(b1s), "b2": torch.stack(b2s),
        "fc": fc.to(mxu_dtype), "fcb": model.fc[0].bias * sf + tf,
    }
    return {k: v.contiguous() for k, v in pack.items()}


def _tconv(g: torch.Tensor, wt: torch.Tensor, mxu_dtype: torch.dtype) -> torch.Tensor:
    """(B, T, 416) -> (B, T, 416): per joint, sum_k g[t + k - 1] @ wt[k],
    zero rows past the clip's edges."""
    b, t, _ = g.shape
    zp = torch.nn.functional.pad(_q(g, mxu_dtype).reshape(b, t, V, C), (0, 0, 0, 0, 1, 1))
    w = _q(wt, mxu_dtype)
    return sum(zp[:, k:k + t] @ w[k] for k in range(3)).reshape(b, t, WIDTH)


@functools.cache
def _tiling() -> dict[str, int]:
    """The tiling constants of `csrc/stgcn.cu`, read from the source the
    kernels are built from: kFTile / kBTile, the rows a forward / backward
    block's products run on, and kFDepth / kBDepth, its rings' stages."""
    src = (_build.CSRC / "stgcn.cu").read_text()
    return {k: int(re.search(rf"\b{k} = (\d+)[,;]", src).group(1))
            for k in ("kFTile", "kFDepth", "kBTile", "kBDepth")}


def plan(batch: int, t: int, direction: str = "forward") -> dict:
    """K7's tiling of a call on (batch, t) motion in ``direction``
    ("forward" or "backward"), as `csrc/stgcn.cu` launches it: per clip,
    ``tiles`` of (lo, hi, x0, x1), a thread block owning frames [lo, hi)
    (``rows`` of them, fewer in the last) and reading the block's input on
    frames [x0, x1), its owned ones and a row of halo each side inside the
    clip; ``tile_rows``, the rows its products run on (forward: the owned
    ones and the halo; backward: the owned ones, its dy tiles holding the
    halo too); ``blocks`` a launch, ``launches`` a call (one a st_gcn
    block), ``threads`` a block (a warp a joint), ``smem_bytes`` a block
    (the most of its launches) and ``smem_budget``, the most one block may
    take on an H100, which leaves room for one block an SM.  The kernel
    reports the same (`kernel_plan`)."""
    if direction not in ("forward", "backward"):
        raise ValueError(f"direction is 'forward' or 'backward', got {direction!r}")
    fwd = direction == "forward"
    k = _tiling()
    tile_rows, depth = (k["kFTile"], k["kFDepth"]) if fwd else (k["kBTile"], k["kBDepth"])
    rows = tile_rows - 2 if fwd else tile_rows
    tiles = [(lo, min(t, lo + rows), max(0, lo - 1), min(t, lo + rows + 1))
             for lo in range(0, t, rows)]
    # bf16: the 416-wide tile (8 values of row padding), the taps, each
    # warp's region: its cp.async ring of 32 x 32 sub-tiles or its 32-wide
    # g / dy tile of tile_rows + 2 rows
    region = max(depth * C * C, (tile_rows + 2) * C) * 2
    smem = tile_rows * (WIDTH + 8) * 2 + 3 * C * C * 2 + WARPS * region
    if fwd:  # the owned rows' float32 residual
        smem += rows * (WIDTH + 8) * 4
    else:  # block 9's dy_out tile: whole m16 fragments over tile_rows + 2 rows
        smem += -(-(tile_rows + 2) // 16) * 16 * (OUT + 8) * 2
    return {"rows": rows, "tile_rows": tile_rows, "tiles": tiles, "blocks": batch * len(tiles),
            "launches": BLOCKS, "threads": 32 * WARPS, "smem_bytes": smem,
            "smem_budget": SMEM_PER_BLOCK}


KERNEL_PLAN_KEYS = ("rows", "tile_rows", "blocks", "threads", "smem_bytes")


def kernel_plan(batch: int, t: int, direction: str = "forward") -> dict:
    """What `csrc/stgcn.cu` launches for a call (its `stgcn_plan`), under
    `plan`'s names ``KERNEL_PLAN_KEYS``; needs the built library."""
    out = (ctypes.c_int * len(KERNEL_PLAN_KEYS))()
    err = _build.library().stgcn_plan(batch, t, int(direction == "backward"), out)
    _build.check(err, "stgcn_plan")
    return dict(zip(KERNEL_PLAN_KEYS, out))


def pack_relu_masks(mask: torch.Tensor) -> torch.Tensor:
    """A boolean (..., 416) mask -> the kernels' bit layout, (..., 13) int32:
    bit c of word v is mask[..., 32 v + c]."""
    bits = mask.reshape(*mask.shape[:-1], V, C).to(torch.int64)
    words = (bits << torch.arange(C, device=mask.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_relu_masks(words: torch.Tensor) -> torch.Tensor:
    """`pack_relu_masks`' inverse: (..., 13) int32 -> (..., 416) bool."""
    bits = (words.to(torch.int64)[..., None] >> torch.arange(C, device=words.device)) & 1
    return bits.reshape(*words.shape[:-1], WIDTH).bool()


def frozen_stgcn_plain(motion: torch.Tensor, pack: dict, mxu_dtype: torch.dtype = torch.bfloat16,
                       *, save: bool = False):
    """The plain version of the forward kernel: (B, T, 13, 2) -> (B, T, 64)
    float32.  With ``save``, also returns what `stgcn_backward` reads, as
    `stgcn_forward` lays it out: the masks [g > 0] and [h > 0] of every
    block, (10, B*T, 13) int32 each (`pack_relu_masks`)."""
    b, t = motion.shape[0], motion.shape[1]
    h = motion.reshape(b, t, IN).float()
    gmask, hmask = [], []
    for i in range(BLOCKS):
        mat = pack["m0"][:IN] if i == 0 else pack["m"][i - 1]
        g = torch.relu(_q(h, mxu_dtype) @ _q(mat, mxu_dtype) + pack["b1"][i])
        y = _tconv(g, pack["wt"][i], mxu_dtype) + pack["b2"][i].repeat(V)
        h = torch.relu(y if i == 0 else y + h)
        if save:
            gmask.append(pack_relu_masks(g.reshape(b * t, WIDTH) > 0))
            hmask.append(pack_relu_masks(h.reshape(b * t, WIDTH) > 0))
    out = _q(h, mxu_dtype) @ _q(pack["fc"], mxu_dtype) + pack["fcb"]
    return (out, (torch.stack(gmask), torch.stack(hmask))) if save else out


def stgcn_backward_plain(dy: torch.Tensor, masks: tuple, pack: dict,
                         mxu_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain version of the backward kernel: the output cotangent (B, T,
    64) and the forward's ``masks`` -> d(motion) (B, T, 13, 2) float32, with
    the JAX backward kernel's roundings (each product's operands in
    ``mxu_dtype``).  From dh = dy FC^T it walks the blocks in reverse: dy_i
    = dh [h_i > 0]; da = (the transposed temporal conv of dy_i) [g_i > 0];
    dh = da M_i^T + dy_i (block 0: dx = da M_0^T)."""
    gmask, hmask = masks
    b, t = dy.shape[0], dy.shape[1]
    dh = _q(dy.float(), mxu_dtype) @ _q(pack["fc"], mxu_dtype).t()
    for i in reversed(range(BLOCKS)):
        dyi = dh * unpack_relu_masks(hmask[i]).reshape(b, t, WIDTH)
        # sum_k dy[t + 1 - k] W_k^T: the forward conv with its taps reversed and transposed
        da = _tconv(dyi, pack["wt"][i].flip(0).transpose(-1, -2), mxu_dtype)
        da = da * unpack_relu_masks(gmask[i]).reshape(b, t, WIDTH)
        mat = pack["m0"][:IN] if i == 0 else pack["m"][i - 1]
        dh = _q(da, mxu_dtype) @ _q(mat, mxu_dtype).t()
        if i > 0:
            dh = dh + dyi
    return dh.reshape(b, t, V, 2)


def _check_pack(pack: dict) -> torch.dtype:
    """The pack's mode, bf16 or float32 (its matrices' dtype); raise
    ValueError unless the pack is the kernels': on the card, matrices all
    in that dtype and float32 biases for 13 joints and 32 channels."""
    mxu = pack["m"].dtype
    if mxu not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the ST-GCN kernels take a bf16 or a float32 pack; got {mxu} matrices")
    for k, s in (("m0", (IN_PAD, WIDTH)), ("m", (BLOCKS - 1, WIDTH, WIDTH)),
                 ("wt", (BLOCKS, 3, C, C)), ("fc", (WIDTH, OUT))):
        _build.require(pack[k], k, mxu, s)
    for k, s in (("b1", (BLOCKS, WIDTH)), ("b2", (BLOCKS, C)), ("fcb", (OUT,))):
        _build.require(pack[k], k, torch.float32, s)
    return mxu


def _check_kernel_args(motion: torch.Tensor, pack: dict, mxu_dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernels take these arguments: operands
    in bf16 or float32, the pack's mode, 13 joints x 2, the pack
    `_check_pack` takes."""
    if mxu_dtype not in (torch.bfloat16, torch.float32) or tuple(motion.shape[2:]) != (V, 2):
        raise ValueError(f"the ST-GCN kernels take bf16 or float32 operands and {V} joints x 2; "
                         f"got {mxu_dtype} operands, motion {tuple(motion.shape)}")
    if pack["m"].dtype != mxu_dtype:
        raise ValueError(f"the ST-GCN kernels take a pack in the operands' dtype (bf16 or "
                         f"float32); got a {pack['m'].dtype} pack, {mxu_dtype} operands")
    _check_pack(pack)


def stgcn_forward(motion: torch.Tensor, pack: dict, *, save: bool = False):
    """K7 forward on the card: (B, T, 13, 2) float32 -> (B, T, 64) float32.
    With ``save``, also returns what `stgcn_backward` needs: every block's
    ReLU masks [g > 0] and [h > 0], (10, B*T, 13) int32 each, as
    `frozen_stgcn_plain` lays them out.  The pack's dtype picks the mode
    (`_check_pack`)."""
    mxu = pack["m"].dtype
    _check_kernel_args(motion, pack, mxu)
    b, t = motion.shape[0], motion.shape[1]
    x = motion.float().contiguous()
    _build.require(x, "motion", torch.float32, (b, t, V, 2))
    rows = b * t
    # bf16: two h slabs used in turn; float32: h (in place) and g
    hbuf = torch.empty((2, rows, WIDTH), dtype=torch.float32, device=x.device)
    masks = torch.empty((2, BLOCKS, rows, V), dtype=torch.int32, device=x.device) if save else None
    out = torch.empty((b, t, OUT), dtype=torch.float32, device=x.device)
    f32 = mxu == torch.float32
    entry = _build.library().stgcn_forward_f32 if f32 else _build.library().stgcn_forward
    err = entry(
        x.data_ptr(), *(pack[k].data_ptr() for k in PACK_KEYS),
        *((hbuf[0].data_ptr(), hbuf[1].data_ptr()) if f32 else (hbuf.data_ptr(),)),
        *((masks[0].data_ptr(), masks[1].data_ptr()) if save else (None, None)), out.data_ptr(),
        b, t, _build.stream())
    _build.check(err, "stgcn_forward_f32" if f32 else "stgcn_forward")
    if f32:
        stgcn_forward.launches_f32 += 1
    else:
        stgcn_forward.launches += 1
    return (out, (masks[0], masks[1])) if save else out


stgcn_forward.launches = 0
stgcn_forward.launches_f32 = 0


def stgcn_backward(dy: torch.Tensor, masks: tuple, pack: dict) -> torch.Tensor:
    """K7 backward on the card: the output cotangent (B, T, 64) and the
    forward's ``masks`` -> d(motion) (B, T, 13, 2) float32, in the pack's
    mode."""
    gmask, hmask = masks
    b, t = dy.shape[0], dy.shape[1]
    f32 = _check_pack(pack) == torch.float32
    dy = dy.float().contiguous()
    _build.require(dy, "dy", torch.float32, (b, t, OUT))
    _build.require(gmask, "gmask", torch.int32, (BLOCKS, b * t, V))
    _build.require(hmask, "hmask", torch.int32, (BLOCKS, b * t, V))
    # bf16: two dh slabs used in turn; float32: dh (in place) and da
    dh = torch.empty((2, b * t, WIDTH), dtype=torch.float32, device=dy.device)
    dx = torch.empty((b, t, V, 2), dtype=torch.float32, device=dy.device)
    weights = [pack[k].data_ptr() for k in ("m0", "m", "wt", "fc")]
    if f32:
        err = _build.library().stgcn_backward_f32(
            dy.data_ptr(), *weights, gmask.data_ptr(), hmask.data_ptr(), dh[0].data_ptr(),
            dh[1].data_ptr(), dx.data_ptr(), b, t, _build.stream())
        _build.check(err, "stgcn_backward_f32")
        stgcn_backward.launches_f32 += 1
    else:
        err = _build.library().stgcn_backward(
            dy.data_ptr(), *weights, gmask.data_ptr(), hmask.data_ptr(), dh.data_ptr(),
            dx.data_ptr(), b, t, _build.stream())
        _build.check(err, "stgcn_backward")
        stgcn_backward.launches += 1
    return dx


stgcn_backward.launches = 0
stgcn_backward.launches_f32 = 0


class _FrozenSTGCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, motion, mxu_dtype, *pack_tensors):
        pack = dict(zip(PACK_KEYS, pack_tensors))
        ctx.mxu_dtype = mxu_dtype
        ctx.save_for_backward(motion, *pack_tensors)
        if not motion.is_cuda:
            return frozen_stgcn_plain(motion, pack, mxu_dtype)
        _check_kernel_args(motion, pack, mxu_dtype)
        if not ctx.needs_input_grad[0]:
            return stgcn_forward(motion, pack)
        out, ctx.masks = stgcn_forward(motion, pack, save=True)
        return out

    @staticmethod
    def backward(ctx, dy):
        motion, *pack_tensors = ctx.saved_tensors
        pack = dict(zip(PACK_KEYS, pack_tensors))
        if motion.is_cuda:
            dx = stgcn_backward(dy, ctx.masks, pack).to(motion.dtype)
            del ctx.masks
        else:
            with torch.enable_grad():
                m = motion.detach().requires_grad_(True)
                (dx,) = torch.autograd.grad(frozen_stgcn_plain(m, pack, ctx.mxu_dtype), m, dy)
        return (dx, None) + (None,) * len(pack_tensors)


def fused_frozen_stgcn(motion: torch.Tensor, pack: dict, mxu_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """(B, T, 13, 2) motion -> (B, T, 64) frozen-encoder latents, with
    ``pack = pack_frozen_stgcn(model, mxu_dtype)``; differentiable with
    respect to ``motion`` only."""
    return _FrozenSTGCN.apply(motion, mxu_dtype, *(pack[k] for k in PACK_KEYS))
