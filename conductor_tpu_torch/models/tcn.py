"""Dilated temporal convolutional network (TCN), the M2SGAN pose decoder's
trunk.

Port of `conductor_tpu/models/tcn.py:19-79` with the reference's module
tree and key names (`Contrastive_Stage/models/TCN.py`), so a reference
generator state dict loads strictly: `DilatedTCN` is the reference's
``TCN`` (``tcn.network.{i}`` TemporalBlocks, then ``linear``).

A `TemporalBlock` registers its convolutions and BatchNorms twice, as the
reference does: as ``conv1`` / ``bn1`` / ``conv2`` / ``bn2`` and inside
``net`` (``net.0``, ``net.2``, ``net.5``, ``net.7``), the same modules.  A
state dict holds both names; torch loads them in registration order, so
``net.*`` is loaded last and wins where the two differ, as in the
reference (`tests/fixtures/torch_m2sgan.npz` was made so).

Per block, twice: reflect padding of (k-1)·d/2 frames a side (edge value
excluded), a VALID dilated convolution whose weight is weight-normed, the
reference's ``weight_g`` / ``weight_v`` parametrisation, BatchNorm with
flax's rule (`models.bn`), ReLU; then a 3-wide average pool (pad 1, the
padding counted), a 1x1 ``downsample`` residual where the widths differ,
and ReLU.  The weight norm is flax's `WeightNorm`: g · v ·
rsqrt(sum v² + 1e-12) over all but the output channel (torch's
`weight_norm` has no epsilon), in float32, before the convolution casts
the weight to the compute dtype.  Dropout is 0, as the JAX decoder
builds it.  Channels first, (B, C, T).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .bn import BatchNorm
from .precision import conv, linear

WEIGHT_NORM_EPS = 1e-12  # flax `_l2_normalize`


class WeightNormConv1d(nn.Module):
    """Conv1d with ``weight = g · v / ||v||`` per output channel."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.weight_g = nn.Parameter(torch.ones(cout, 1, 1))
        self.weight_v = nn.Parameter(torch.randn(cout, cin, kernel_size) * 0.01)
        self.bias = nn.Parameter(torch.zeros(cout))

    def weight(self) -> torch.Tensor:
        v = self.weight_v.float()
        return self.weight_g * v * torch.rsqrt((v * v).sum(dim=(1, 2), keepdim=True)
                                               + WEIGHT_NORM_EPS)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """VALID dilated convolution of (B, Cin, T) in ``dtype``."""
        if dtype == torch.float32:
            return F.conv1d(x.float(), self.weight(), self.bias, dilation=self.dilation)
        y = F.conv1d(x.to(dtype), self.weight().to(dtype), None, dilation=self.dilation)
        return y + self.bias.to(dtype)[:, None]


class TemporalBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation // 2
        self.conv1 = WeightNormConv1d(cin, cout, kernel_size, dilation)
        self.bn1 = BatchNorm(cout)
        self.conv2 = WeightNormConv1d(cout, cout, kernel_size, dilation)
        self.bn2 = BatchNorm(cout)
        # the reference's second view of the same modules (its keys)
        self.net = nn.Sequential(self.conv1, nn.Identity(), self.bn1, nn.ReLU(), nn.Dropout(0.0),
                                 self.conv2, nn.Identity(), self.bn2, nn.ReLU(), nn.Dropout(0.0))
        self.downsample = nn.Conv1d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, Cin, T) -> (B, Cout, T) in ``dtype``; T > 2 · pad."""
        y = x
        for wn_conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            y = wn_conv(F.pad(y, (self.pad, self.pad), mode="reflect"), dtype)
            y = torch.relu(bn(y, dtype=dtype))
        y = F.avg_pool1d(y, 3, 1, 1)
        if self.downsample is not None:
            x = conv(self.downsample, x, dtype)
        return torch.relu(y + x)


class DilatedTCN(nn.Module):
    """Stacked TemporalBlocks (dilation 2^i), then a per-frame linear:
    (B, T, Cin) -> (B, T, output_size), channel-last in and out."""

    def __init__(self, cin: int, output_size: int = 64, n_layers: int = 6, n_channel: int = 64,
                 kernel_size: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        blocks = [TemporalBlock(cin if i == 0 else n_channel, n_channel, kernel_size, 2 ** i)
                  for i in range(n_layers)]
        self.tcn = nn.ModuleDict({"network": nn.Sequential(*blocks)})
        self.linear = nn.Linear(n_channel, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for blk in self.tcn["network"]:
            h = blk(h, self.dtype)
        return linear(self.linear, h.transpose(1, 2), self.dtype)
