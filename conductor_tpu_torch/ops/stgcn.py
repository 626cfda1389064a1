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

`fused_frozen_stgcn` is a `torch.autograd.Function`.  On CPU tensors it
runs the plain version, and its backward is autograd through it.  On CUDA
tensors the forward is `stgcn_forward` and the backward `stgcn_backward`,
the kernels in `csrc/stgcn.cu`, which take bf16 operands, 13 joints and 32
channels; anything else raises.  The pack takes no gradient.
"""

from __future__ import annotations

import torch

from . import _build
from .conv_block import _q

V, C, BLOCKS, OUT = 13, 32, 10, 64  # joints, channels, st_gcn blocks, latent width
IN = V * 2       # a frame of motion: 13 joints x (x, y)
IN_PAD = 32      # block 0's matrix rows, padded with zeros to a whole 16-deep MMA step
WIDTH = V * C    # 416 values a frame between blocks
PACK_KEYS = ("m0", "m", "wt", "b1", "b2", "fc", "fcb")


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


def frozen_stgcn_plain(motion: torch.Tensor, pack: dict, mxu_dtype: torch.dtype = torch.bfloat16,
                       *, save: bool = False):
    """The plain version of the kernels: (B, T, 13, 2) -> (B, T, 64) float32.
    With ``save``, also returns what `stgcn_backward` reads, as
    `stgcn_forward` lays it out: every block's h (10, B*T, 416) float32 and
    g (10, B*T, 416) in ``mxu_dtype``."""
    b, t = motion.shape[0], motion.shape[1]
    h = motion.reshape(b, t, IN).float()
    hs, gs = [], []
    for i in range(BLOCKS):
        mat = pack["m0"][:IN] if i == 0 else pack["m"][i - 1]
        g = torch.relu(_q(h, mxu_dtype) @ _q(mat, mxu_dtype) + pack["b1"][i])
        y = _tconv(g, pack["wt"][i], mxu_dtype) + pack["b2"][i].repeat(V)
        h = torch.relu(y if i == 0 else y + h)
        if save:
            hs.append(h.reshape(b * t, WIDTH))
            gs.append(g.reshape(b * t, WIDTH).to(mxu_dtype))
    out = _q(h, mxu_dtype) @ _q(pack["fc"], mxu_dtype) + pack["fcb"]
    return (out, (torch.stack(hs), torch.stack(gs))) if save else out


def _check_pack(pack: dict) -> None:
    """Raise ValueError unless the pack is the kernels': on the card, bf16
    matrices and float32 biases for 13 joints and 32 channels."""
    for k, s in (("m0", (IN_PAD, WIDTH)), ("m", (BLOCKS - 1, WIDTH, WIDTH)),
                 ("wt", (BLOCKS, 3, C, C)), ("fc", (WIDTH, OUT))):
        _build.require(pack[k], k, torch.bfloat16, s)
    for k, s in (("b1", (BLOCKS, WIDTH)), ("b2", (BLOCKS, C)), ("fcb", (OUT,))):
        _build.require(pack[k], k, torch.float32, s)


def _check_kernel_args(motion: torch.Tensor, pack: dict, mxu_dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernels take these arguments: bf16
    operands, 13 joints x 2, the pack `_check_pack` takes."""
    if mxu_dtype != torch.bfloat16 or tuple(motion.shape[2:]) != (V, 2):
        raise ValueError(f"the ST-GCN kernels take bf16 operands and {V} joints x 2; got "
                         f"{mxu_dtype} operands, motion {tuple(motion.shape)}")
    _check_pack(pack)


def stgcn_forward(motion: torch.Tensor, pack: dict, *, save: bool = False):
    """K7 forward on the card: (B, T, 13, 2) float32 -> (B, T, 64) float32.
    With ``save``, also returns what `stgcn_backward` needs: every block's
    output h (10, B*T, 416) float32 and graph-conv activation g (10, B*T,
    416) bf16."""
    _check_kernel_args(motion, pack, torch.bfloat16)
    b, t = motion.shape[0], motion.shape[1]
    x = motion.float().contiguous()
    _build.require(x, "motion", torch.float32, (b, t, V, 2))
    rows = b * t
    hbuf = torch.empty((BLOCKS if save else 2, rows, WIDTH), dtype=torch.float32, device=x.device)
    gbuf = torch.empty((BLOCKS if save else 1, rows, WIDTH), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((b, t, OUT), dtype=torch.float32, device=x.device)
    err = _build.library().stgcn_forward(
        x.data_ptr(), *(pack[k].data_ptr() for k in PACK_KEYS), hbuf.data_ptr(),
        gbuf.data_ptr(), out.data_ptr(), b, t, int(save), _build.stream())
    _build.check(err, "stgcn_forward")
    stgcn_forward.launches += 1
    return (out, (hbuf, gbuf)) if save else out


stgcn_forward.launches = 0


def stgcn_backward(dy: torch.Tensor, saved: tuple, pack: dict) -> torch.Tensor:
    """K7 backward on the card: the output cotangent (B, T, 64) and the
    forward's ``saved`` -> d(motion) (B, T, 13, 2) float32."""
    hbuf, gbuf = saved
    b, t = dy.shape[0], dy.shape[1]
    _check_pack(pack)
    dy = dy.float().contiguous()
    _build.require(dy, "dy", torch.float32, (b, t, OUT))
    _build.require(hbuf, "h", torch.float32, (BLOCKS, b * t, WIDTH))
    _build.require(gbuf, "g", torch.bfloat16, (BLOCKS, b * t, WIDTH))
    dh = torch.empty((2, b * t, WIDTH), dtype=torch.float32, device=dy.device)
    da = torch.empty((b * t, WIDTH), dtype=torch.bfloat16, device=dy.device)
    dx = torch.empty((b, t, V, 2), dtype=torch.float32, device=dy.device)
    err = _build.library().stgcn_backward(
        dy.data_ptr(), *(pack[k].data_ptr() for k in ("m0", "m", "wt", "fc")), hbuf.data_ptr(),
        gbuf.data_ptr(), dh.data_ptr(), da.data_ptr(), dx.data_ptr(), b, t, _build.stream())
    _build.check(err, "stgcn_backward")
    stgcn_backward.launches += 1
    return dx


stgcn_backward.launches = 0


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
        out, ctx.kernel_saved = stgcn_forward(motion, pack, save=True)
        return out

    @staticmethod
    def backward(ctx, dy):
        motion, *pack_tensors = ctx.saved_tensors
        pack = dict(zip(PACK_KEYS, pack_tensors))
        if motion.is_cuda:
            dx = stgcn_backward(dy, ctx.kernel_saved, pack).to(motion.dtype)
            del ctx.kernel_saved
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
