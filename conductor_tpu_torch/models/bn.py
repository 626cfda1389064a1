"""BatchNorm with flax's training semantics.

flax's `nn.BatchNorm`, which every BatchNorm of the JAX package is
(`conductor_tpu/models/music_encoder.py`, `stgcn.py`; `_PackedBatchNorm` of
the packed encoder path has the same rule), differs from torch's in train
mode in one respect: the running variance moves toward the BIASED batch
variance, where torch uses the unbiased one (0.8 % apart at the ST-GCN's
``data_bn`` over B * T = 120 frames).  The momentum is flax's 0.99, torch's
``momentum=0.01``; eps 1e-5; batch statistics in float32 whatever the
activations' dtype, the output in that dtype or in the ``dtype`` given (flax's
``nn.BatchNorm(dtype=...)``, `models.precision`).  Eval mode normalises with
the running statistics, as torch's BatchNorm.

`BatchNorm` keeps the reference key names (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so reference
state dicts load strictly into the modules that use it.

flax returns the new running statistics from ``apply``; here a train-mode
forward moves them in place.  Inside `batch_statistics_only` it does not:
a forward that autograd recomputes (``torch.utils.checkpoint``, the
trainers' ``remat``) must not move them a second time, and precise-BN
recalibration reads each BatchNorm's batch statistics there instead.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch import nn

_scope = threading.local()  # autograd may recompute a forward on its own thread


@contextmanager
def batch_statistics_only(record: dict | None = None):
    """Inside, train-mode BatchNorms normalise by their batch statistics
    and leave ``running_mean``, ``running_var`` and ``num_batches_tracked``
    as they are; with ``record``, each stores its float32 batch (mean,
    var) there under itself."""
    outer = getattr(_scope, "frozen", None)
    _scope.frozen = {} if record is None else record
    try:
        yield
    finally:
        _scope.frozen = outer


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Per-channel BatchNorm over every axis but ``channel_dim`` (1, torch's
    NC... layout, by default; -1 for channel-last activations)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"BatchNorm takes at least 2-D input, got {x.dim()}-D")

    def forward(self, x: torch.Tensor, channel_dim: int = 1,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        channel_dim %= x.dim()
        x32 = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            dims = [d for d in range(x.dim()) if d != channel_dim]
            var, mean = torch.var_mean(x32, dim=dims, correction=0)
            frozen = getattr(_scope, "frozen", None)
            if frozen is not None:
                frozen[self] = (mean.detach(), var.detach())
            else:
                with torch.no_grad():
                    for stat, batch in ((self.running_mean, mean), (self.running_var, var)):
                        stat.mul_(1.0 - self.momentum).add_(batch, alpha=self.momentum)
                    self.num_batches_tracked += 1
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        return (x32 * scale.view(shape) + shift.view(shape)).to(dtype or x.dtype)
