"""The ST-GCN motion encoder: trained in stage 1, frozen in stage 2's
perceptual loss.

Port of `conductor_tpu/models/stgcn.py:103-247`: `STGCN`, data BatchNorm
over the flattened (V*C) frame, then st_gcn blocks (graph conv with a
learnable edge-importance mask on the adjacency, then BN -> ReLU -> 3x1
temporal conv, strided in some blocks, -> BN, plus a residual: none, the
identity, or a strided 1x1 conv with BN where the width or the stride
changes), in the "M2S" mode (ten blocks of 32, stride 1: M2SNet, the
perceptual loss and FGD) or the "AE" mode (eight blocks of 16 with
temporal strides 3 and 2, the autoencoder variant, which nothing in either
package builds); `MotionEncoderSTGCN`, the M2S ST-GCN and a 1x1 projection
of the channel-major (C, V) flatten to 64 channels with BN.

Plain PyTorch modules in the reference's own NCTV layout and key names
(`st_gcn.st_gcn_networks.{i}.gcn.conv`, `.tcn.{0,2,3}`,
`st_gcn.edge_importance.{i}`, `st_gcn.data_bn`, `fc.{0,1}`, and the
adjacency buffer `st_gcn.A`), so a reference ``motion_encoder.*`` subtree
loads strictly.  `st_gcn.fcn` is the reference's classifier head, which the
encoder never runs; it is kept so that the keys match.  The BatchNorms
(`models.bn`) follow flax's rule in train mode.  Stage 1 trains the module
as it is (plain, as the JAX package runs it); the stage-2 trainer keeps it
frozen (`freeze`: eval BatchNorm, no parameter gradients, gradients to its
input only) and runs it on K7 (`ops.stgcn`), packed from these weights.

``dtype`` rounds where the flax module's ``dtype=`` does (`models.precision`,
JAX `models/stgcn.py:33-137`): the BatchNorms and the projection return
``dtype``, the graph and temporal convolutions take their product in it
and add their bias in float32, as the JAX module's hand-written
convolutions do, so those two return float32 into the next BatchNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from .bn import BatchNorm
from .graph import build_adjacency
from .precision import conv

# (out channels, temporal stride, residual) per block of each mode
# (`conductor_tpu/models/stgcn.py:141-148`)
MODE_BLOCKS = {
    "M2S": [(32, 1, False)] + [(32, 1, True)] * 9,
    "AE": [(16, 1, False), (16, 1, True), (16, 3, True), (16, 1, True),
           (16, 1, True), (16, 2, True), (16, 1, True), (16, 1, True)],
}
M2S_BLOCKS = MODE_BLOCKS["M2S"]


class ConvTemporalGraphical(nn.Module):
    """1x1 conv to K*C channels, then the adjacency contraction over joints."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.conv = nn.Conv2d(cin, cout * k, 1)

    def forward(self, x: torch.Tensor, a: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        # as the JAX module: the product in ``dtype``, the bias contracted
        # apart and added in float32
        y = self.conv._conv_forward(x.to(dtype), self.conv.weight.to(dtype), None)
        b, kc, t, v = y.shape
        y = torch.einsum("nkctv,kvw->nctw", y.reshape(b, self.k, kc // self.k, t, v), a.to(dtype))
        return y + torch.einsum("kc,kvw->cw", self.conv.bias.reshape(self.k, -1), a)[:, None]


class STGCNBlock(nn.Module):
    """One st_gcn block; its residual none, the identity, or (where the
    width or the stride changes) a strided 1x1 conv and BN
    (``residual.{0,1}``, registered after ``tcn`` as in the reference)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, residual: bool):
        super().__init__()
        self.res_mode = "none" if not residual else (
            "identity" if cin == cout and stride == 1 else "conv")
        self.gcn = ConvTemporalGraphical(cin, cout, k)
        self.tcn = nn.Sequential(
            BatchNorm(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, (3, 1), (stride, 1), (1, 0)),
            BatchNorm(cout), nn.Dropout(0.0),
        )
        if self.res_mode == "conv":
            self.residual = nn.Sequential(nn.Conv2d(cin, cout, 1, (stride, 1)), BatchNorm(cout))

    def forward(self, x: torch.Tensor, a: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        bn1, _, tconv, bn2, _ = self.tcn
        y = torch.relu(bn1(self.gcn(x, a, dtype), dtype=dtype))
        y = bn2(conv(tconv, y, dtype, bias_dtype=torch.float32), dtype=dtype)
        if self.res_mode == "identity":
            y = y + x
        elif self.res_mode == "conv":
            rconv, rbn = self.residual
            y = y + rbn(conv(rconv, x, dtype), dtype=dtype)
        return torch.relu(y)


class STGCN(nn.Module):
    """motion (B, T, V, C) -> (B, C_out, T', V): the blocks of ``mode``
    ("M2S" or "AE")."""

    def __init__(self, in_channels: int = 2, layout: str = "ConductorMotionX", mode: str = "M2S"):
        super().__init__()
        if mode not in MODE_BLOCKS:
            raise ValueError(f"mode is one of {sorted(MODE_BLOCKS)}, got {mode!r}")
        a = torch.from_numpy(build_adjacency(layout, "uniform"))
        self.register_buffer("A", a)
        k, v = a.shape[0], a.shape[1]
        self.data_bn = BatchNorm(in_channels * v)
        cin, blocks = in_channels, []
        for cout, stride, residual in MODE_BLOCKS[mode]:
            blocks.append(STGCNBlock(cin, cout, k, stride, residual))
            cin = cout
        self.st_gcn_networks = nn.ModuleList(blocks)
        self.edge_importance = nn.ParameterList(nn.Parameter(torch.ones_like(a)) for _ in blocks)
        self.fcn = nn.Conv2d(256, cin, 1)  # the reference's unused classifier head

    def forward(self, motion: torch.Tensor, dtype: torch.dtype = torch.float32,
                feats: list | None = None) -> torch.Tensor:
        """motion (B, T, V, C) -> (B, C_out, T, V) in ``dtype``.  With
        ``feats``, appends to it the normalised input and every block's
        output, each flattened channel-major to (B, T, C*V), as JAX
        `extract_feature` (`conductor_tpu/models/stgcn.py:200-211`)."""
        b, t, v, c = motion.shape
        x = self.data_bn(motion.reshape(b, t, v * c).transpose(1, 2), dtype=dtype)
        x = x.reshape(b, v, c, t).permute(0, 2, 3, 1)
        keep = (lambda h: feats.append(h.permute(0, 2, 1, 3).reshape(b, h.shape[2], -1))
                if feats is not None else None)
        keep(x)
        for blk, imp in zip(self.st_gcn_networks, self.edge_importance):
            x = blk(x, self.A * imp, dtype)
            keep(x)
        return x


class MotionEncoderSTGCN(nn.Module):
    """(B, T, 13, 2) motion -> (B, T, 64) latents."""

    def __init__(self, out_dim: int = 64, n_joints: int = 13, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.st_gcn = STGCN()
        width = M2S_BLOCKS[-1][0] * n_joints
        self.fc = nn.Sequential(nn.Conv1d(width, out_dim, 1), BatchNorm(out_dim))

    def forward(self, motion: torch.Tensor) -> torch.Tensor:
        return self._project(self.st_gcn(motion, self.dtype))

    def features(self, motion: torch.Tensor) -> list[torch.Tensor]:
        """The perceptual feature stack (`conductor_tpu/models/stgcn.py:
        236-247`): the normalised input and the 10 blocks' maps, (B, T,
        C*V) channel-major, then the (B, T, 64) latents."""
        feats: list[torch.Tensor] = []
        h = self.st_gcn(motion, self.dtype, feats)
        return feats + [self._project(h)]

    def _project(self, h: torch.Tensor) -> torch.Tensor:
        b, c, t, v = h.shape
        # channel-major (C, V) flatten, as the reference's NCTV flatten
        proj, bn = self.fc
        return bn(conv(proj, h.transpose(2, 3).reshape(b, c * v, t), self.dtype)).transpose(1, 2)

    def freeze(self) -> "MotionEncoderSTGCN":
        """Eval BatchNorm and no parameter gradients."""
        self.requires_grad_(False)
        return self.eval()
