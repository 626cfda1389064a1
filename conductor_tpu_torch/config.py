"""Configuration for the PyTorch port.

Counterpart of `conductor_tpu/config.py:163-239`.  The dataclasses and their
JSON format are the JAX package's own (that module imports no jax); only the
resolution of the "auto" implementation knobs is the port's: on a CUDA
device "auto" selects the hand-written kernels and bf16 matmul operands,
anywhere else the plain PyTorch modules in float32.  `conductor_tpu.config.
resolve_auto` is not called because it asks jax for its backend.
"""

from __future__ import annotations

import dataclasses

import torch

from conductor_tpu.config import (  # noqa: F401  (re-exported)
    Config,
    DatasetSpec,
    DenoiserConfig,
    DiffusionConfig,
    MeshConfig,
    TrainConfig,
    pin_faithful,
)

# (denoiser field) -> (value on a CUDA device, value elsewhere), for the
# "auto" knobs the port reads.  The names are the shared config's:
# "pallas_fused" / "pallas" mean "the kernel path", which in this package is
# CUDA C++ (`conductor_tpu_torch/csrc/`).
_AUTO_FIELDS = {
    "compute_dtype": ("bfloat16", "float32"),
    "layer_impl": ("pallas_fused", "flax"),
    "train_layer_impl": ("pallas_fused", "flax"),
    "music_encoder_impl": ("pallas", "flax"),
}


def resolve_auto(cfg: Config, device: torch.device | str) -> Config:
    """Resolve the "auto" implementation knobs for ``device``.  Explicit
    values are kept as given.  As in the JAX package, "auto" training layers
    fall back to the plain modules when dropout is on or the reference mask
    is replicated, and "auto" falls back where a kernel's gate fails:
    ``feat_impl`` "auto" is the ST-GCN kernel (K7, "pallas") on a CUDA
    device when the compute dtype resolves to bfloat16, the kernel's
    operands, and the plain module ("flax") otherwise.  Idempotent."""
    cuda = torch.device(device).type == "cuda"
    d = cfg.denoiser
    resolved = {
        k: (cuda_v if cuda else plain_v) if getattr(d, k) == "auto" else getattr(d, k)
        for k, (cuda_v, plain_v) in _AUTO_FIELDS.items()
    }
    if d.train_layer_impl == "auto" and (d.dropout != 0.0 or cfg.train.replicate_reference_mask):
        resolved["train_layer_impl"] = "flax"
    feat = cfg.train.feat_impl
    if feat == "auto":
        feat = "pallas" if cuda and resolved["compute_dtype"] == "bfloat16" else "flax"
    return cfg.replace(denoiser=dataclasses.replace(d, **resolved),
                       train=dataclasses.replace(cfg.train, feat_impl=feat))
