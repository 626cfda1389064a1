"""flax's ``dtype=`` rule for the port's plain modules, and float32 without
TF32.

A flax module built with ``dtype=bfloat16`` keeps its parameters in float32
and rounds at fixed points (flax `linen/linear.py`, `Dense` and `Conv`;
`linen/normalization.py`, `LayerNorm` and `BatchNorm`):

- `Dense` and `Conv` cast their input, kernel and bias to the dtype, take
  the product in it and then add the bias in it, so they return the dtype;
- `LayerNorm` and `BatchNorm` take their statistics and normalise in
  float32 from the input, and return the dtype.

`linear`, `conv` and `layer_norm` apply that rule to a torch module's own
parameters, so the reference key names and state dicts stay as they are;
`models.bn.BatchNorm` takes the same ``dtype``.  At float32 each is the
torch module's own float32 call.

`full_float32` scopes TF32 off: on a CUDA card torch runs float32
convolutions in TF32 (a 10-bit mantissa) unless
``torch.backends.cudnn.allow_tf32`` is False, so the entry points run
inside it and float32 stays float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` on ``layer``'s parameters."""
    if dtype == torch.float32:
        return F.linear(x.float(), layer.weight, layer.bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def conv(layer: nn.Conv1d | nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
         bias_dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype)`` on ``layer``'s parameters (channels
    first); with ``bias_dtype`` the bias is added in that dtype instead, as
    the JAX ST-GCN's hand-written convolutions add their float32 bias."""
    if dtype == torch.float32:
        return layer(x.float())
    y = layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)
    return y + layer.bias.to(bias_dtype or dtype).view(-1, *[1] * (y.dim() - 2))


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)`` on ``layer``'s parameters."""
    y = F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps)
    return y.to(dtype)


@contextlib.contextmanager
def full_float32():
    """cuDNN and cuBLAS without TF32 inside; the caller's two flags are
    restored on the way out."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = False
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
