"""Mel-spectrogram music encoder (90 Hz mel -> 30 Hz frame features).

Port of `conductor_tpu/models/music_encoder.py`: `MusicEncoder` (`:115-268`)
as plain PyTorch modules with the reference key names
(`music_encoder.conv1.0.conv2d_layer.0.weight`, ...), and
`FusedMusicEncoder` (`:271-344`), which serves: each Conv2dResBlock as one
`ops.conv_block.fused_conv_block` call with BN folded in
(`ops/pallas_conv.py:68-72`) and the stage pools as its epilogue.

`MusicEncoder` trains in either of the JAX package's two paths, on the same
parameters: ``conv_impl="lax"``, plain NCHW modules with T as height that
round where flax's ``dtype=`` does (`models.precision`: each conv in the
compute dtype, BatchNorm in float32 returning it), and
``conv_impl="pallas_train"`` (`:22-112, 158-181, 231-254`), NHWC (B, T, F,
C) activations in the compute dtype, each 3x3 conv on
`ops.conv_train.conv3x3_train` (K4 forward and d(input), K9 d(kernel)),
then the bias, BatchNorm in float32 from the activations, ReLU and the
residual (identity, or a 1x1 conv as one matmul + BN) in plain PyTorch, and
each stage's pool on `ops.max_pool.max_pool_train` (K10, K11).  The
BatchNorms (`models.bn`) follow flax's rule in train mode.

Numerics copied from the JAX package: convs pad by reflection (edge value
excluded), pools pad with -inf, and the flatten before the projection is
channel-major (C, F).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_block import fold_bn, fused_conv_block
from ..ops.conv_train import conv3x3_train
from ..ops.max_pool import max_pool_train
from .bn import BatchNorm
from .precision import conv

CONV_IMPLS = ("lax", "pallas_train")


class Conv2dResBlock(nn.Module):
    """Reflect-padded 3x3 conv + BN + ReLU, plus a residual that is the
    identity (Cin == Cout) or a 1x1 conv + BN."""

    def __init__(self, cin: int, cout: int, residual: bool = True):
        super().__init__()
        self.conv2d_layer = nn.Sequential(nn.Conv2d(cin, cout, 3), BatchNorm(cout), nn.ReLU())
        self.res_mode = 0 if not residual else (1 if cin == cout else 2)
        if self.res_mode == 2:
            self.residual = nn.Sequential(nn.Conv2d(cin, cout, 1), BatchNorm(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x (B, Cin, T, F) -> (B, Cout, T, F) in ``dtype``."""
        conv_, bn = self.conv2d_layer[0], self.conv2d_layer[1]
        y = torch.relu(bn(conv(conv_, F.pad(x, (1, 1, 1, 1), mode="reflect"), dtype)))
        if self.res_mode == 1:
            return y + x
        if self.res_mode == 2:
            rconv, rbn = self.residual
            return y + rbn(conv(rconv, x, dtype))
        return y

    def forward_packed(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, F, Cin) -> (B, T, F, Cout) in x's dtype, the conv on
        `conv3x3_train` over a differentiable view of the same weights."""
        conv, bn = self.conv2d_layer[0], self.conv2d_layer[1]
        y = conv3x3_train(x, conv.weight.permute(2, 3, 1, 0)) + conv.bias.to(x.dtype)
        y = torch.relu(bn(y, channel_dim=-1))
        if self.res_mode == 1:
            return y + x
        if self.res_mode == 2:
            rconv, rbn = self.residual
            r = torch.matmul(x, rconv.weight[:, :, 0, 0].t().to(x.dtype)) + rconv.bias.to(x.dtype)
            return y + rbn(r, channel_dim=-1)
        return y


# each stage's trailing max-pool over (time, freq): window, strides, padding
POOLS = {
    "conv1": ((5, 5), (1, 2), ((2, 2), (2, 2))),
    "conv2": ((5, 5), (3, 2), ((2, 2), (2, 2))),
    "conv3": ((3, 3), (1, 2), ((1, 1), (1, 1))),
}


def max_pool(x: torch.Tensor, pool) -> torch.Tensor:
    """NCHW max-pool with -inf padding."""
    window, strides, padding = pool
    return F.max_pool2d(x, window, strides, (padding[0][0], padding[1][0]))


class MusicEncoder(nn.Module):
    """(B, T90, 128) mel -> (B, T30, out_dim) frame features.

    ``conv_impl`` picks the conv-stage path ("lax": the plain modules;
    "pallas_train": the packed NHWC path on the kernels); both compute in
    ``dtype`` and return it.  Train mode normalises with batch statistics
    and moves the running ones (`models.bn`)."""

    def __init__(self, out_dim: int = 64, conv_impl: str = "lax",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        self.conv_impl, self.dtype = conv_impl, dtype
        self.conv1 = nn.Sequential(
            Conv2dResBlock(1, 16, residual=False), Conv2dResBlock(16, 16), Conv2dResBlock(16, 16)
        )
        self.conv2 = nn.Sequential(Conv2dResBlock(16, 32), Conv2dResBlock(32, 32))
        self.conv3 = nn.Sequential(Conv2dResBlock(32, 32), Conv2dResBlock(32, 32))
        self.conv4 = nn.Sequential(nn.Conv1d(512, out_dim, 1), BatchNorm(out_dim))

    def forward(self, mel: torch.Tensor, maps: list | None = None) -> torch.Tensor:
        """The latents (B, T30, out_dim); with ``maps``, also appends the
        three pooled maps to it, as `features` lists them."""
        if self.conv_impl == "pallas_train":
            return self._forward_packed(mel, maps)
        x = mel[:, None]  # (B, 1, T90, 128)
        for name in ("conv1", "conv2", "conv3"):
            for blk in getattr(self, name):
                x = blk(x, self.dtype)
            x = max_pool(x, POOLS[name])
            if maps is not None and name != "conv3":
                maps.append(x.permute(0, 2, 3, 1).flatten(2))  # (B, T, F*C)
        b, c, t, f = x.shape
        h = x.permute(0, 2, 1, 3).reshape(b, t, c * f)  # channel-major (C, F)
        if maps is not None:
            maps.append(h)
        proj, bn = self.conv4
        return bn(conv(proj, h.transpose(1, 2), self.dtype)).transpose(1, 2)

    def _forward_packed(self, mel: torch.Tensor, maps: list | None) -> torch.Tensor:
        x = mel.to(self.dtype).contiguous()[..., None]  # (B, T90, 128, 1); a crop is a view
        for name in ("conv1", "conv2", "conv3"):
            for blk in getattr(self, name):
                x = blk.forward_packed(x)
            x = max_pool_train(x, POOLS[name])
            if maps is not None and name != "conv3":
                maps.append(x.flatten(2))  # (B, T, F*C)
        b, t, f, c = x.shape
        h = x.permute(0, 1, 3, 2).reshape(b, t, c * f)  # channel-major (C, F)
        if maps is not None:
            maps.append(h)
        proj, bn = self.conv4
        return bn(F.linear(h, proj.weight[:, :, 0].to(h.dtype), proj.bias.to(h.dtype)),
                  channel_dim=-1)

    def features(self, mel: torch.Tensor) -> list[torch.Tensor]:
        """Every map, channel-last (B, T, C), as JAX `features` (`:261-268`):
        the mel, the first two stages' pooled maps flattened (F, C) (frequency
        major), the third's flattened (C, F) (channel major) and the
        projection, (B, T30, out_dim)."""
        maps = [mel]
        return maps + [self(mel, maps)]


class FusedMusicEncoder:
    """Inference MusicEncoder on the fused conv-block kernel, one call per
    Conv2dResBlock, built from a `MusicEncoder`'s eval-mode weights."""

    def __init__(self, encoder: MusicEncoder, mxu_dtype: torch.dtype = torch.bfloat16):
        self.mxu_dtype = mxu_dtype
        self.block_args = []
        with torch.no_grad():
            for name in ("conv1", "conv2", "conv3"):
                stage = getattr(encoder, name)
                for i, blk in enumerate(stage):
                    conv, bn = blk.conv2d_layer[0], blk.conv2d_layer[1]
                    scale, bias = fold_bn(conv.bias, bn.running_mean, bn.running_var,
                                          bn.weight, bn.bias, bn.eps)
                    kw = dict(
                        kernel=conv.weight.permute(2, 3, 1, 0).contiguous(),
                        scale=scale, bias=bias, res_mode=blk.res_mode,
                        pool=POOLS[name] if i == len(stage) - 1 else None,
                    )
                    if blk.res_mode == 2:
                        rconv, rbn = blk.residual
                        rs, rb = fold_bn(rconv.bias, rbn.running_mean, rbn.running_var,
                                         rbn.weight, rbn.bias, rbn.eps)
                        kw.update(res_kernel=rconv.weight[:, :, 0, 0].t().contiguous(),
                                  res_scale=rs, res_bias=rb)
                    self.block_args.append(kw)
            proj, bn = encoder.conv4
            self.proj_w = proj.weight[:, :, 0].t().contiguous()  # (C*F, out)
            self.proj_scale, self.proj_bias = fold_bn(
                proj.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps
            )

    @torch.no_grad()
    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.to(self.mxu_dtype).contiguous()[..., None]  # (B, T90, 128, 1)
        for kw in self.block_args:
            x = fused_conv_block(x, mxu_dtype=self.mxu_dtype, **kw)
        b, t, f, c = x.shape
        h = x.permute(0, 1, 3, 2).reshape(b, t, c * f).float()
        # the projection one GEMM a clip: a GEMM library picks its kernel,
        # and with it the summation order, by the row count, so one product
        # over the batch's rows would make a clip's features depend on the
        # batch it is served in (a sharded wave's rows on a rank against the
        # whole wave in one process: 3.4e-6 of 3.06 on the card, 3e-3 of
        # the motion after a ddim50 ladder)
        proj = torch.stack([torch.matmul(h[i], self.proj_w) for i in range(b)])
        return proj * self.proj_scale + self.proj_bias
