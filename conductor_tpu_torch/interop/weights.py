"""Reference-format weights into the port's modules.

The port's modules carry the reference state-dict key names, so weights
cross over without a mapping: a reference checkpoint, a state dict that the
JAX package's exporter (`conductor_tpu/interop/torch_export.py`) made from a
flax tree, or `synth.synth_state_dict` weights.  Load is strict.  The
DataParallel ``module.`` prefix is stripped and a stage-2 ``latest.tar`` dict (`Diffusion_Stage/trainers/ddpm_trainer.py:290-319`)
contributes its ``encoder`` entry, as `conductor_tpu.interop.torch_import`
does for the JAX package.  The frozen ST-GCN of the perceptual loss loads
from its own subtree or from a whole stage-1 M2SNet state dict
(`load_motion_encoder_state_dict`), and a whole M2SNet from its state dict
(`load_m2snet_state_dict`); the checkpoint's adjacency buffer must equal
the port's graph.  The M2SGAN generator and critic load from their own
state dicts (`load_generator_state_dict`, `load_discriminator_state_dict`:
`load_reference_state_dict` under the names of what they load),
and a stage-1 M2SNet's music encoder, its parameters and BatchNorm
statistics, transfers into a generator (`load_music_encoder_from_m2snet`,
reference `M2SGAN_train.py:61-62`).
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .synth import synth_state_dict


def reference_state_dict(obj) -> dict[str, torch.Tensor]:
    """A flat ``{key: tensor}`` state dict from a mapping of numpy arrays or
    tensors, a ``{"encoder": ...}`` checkpoint dict, or a path to a file
    holding either."""
    if isinstance(obj, (str, os.PathLike)):
        obj = torch.load(obj, map_location="cpu", weights_only=True)
    if isinstance(obj.get("encoder"), Mapping):
        obj = obj["encoder"]
    return {
        k.removeprefix("module."): v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
        for k, v in obj.items()
    }


def load_reference_state_dict(module: nn.Module, sd) -> None:
    """Load reference-format weights into ``module``, strictly."""
    module.load_state_dict(reference_state_dict(sd), strict=True)


def load_motion_encoder_state_dict(module: nn.Module, sd) -> None:
    """Load a reference ``MotionEncoder_STGCN`` state dict into the port's
    `MotionEncoderSTGCN`, strictly: either the bare subtree or an M2SNet
    state dict, whose ``motion_encoder.*`` keys are taken.  Raises if the
    checkpoint's adjacency differs from the port's (`check_adjacency` in
    `conductor_tpu/interop/torch_import.py`)."""
    sd = reference_state_dict(sd)
    prefix = "motion_encoder."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    _check_adjacency(module.st_gcn.A, sd.get("st_gcn.A"))
    module.load_state_dict(sd, strict=True)


def load_m2snet_state_dict(module: nn.Module, sd) -> None:
    """Load a reference M2SNet state dict (bare or ``module.``-prefixed, or a
    path) into the port's `models.m2snet.M2SNet`, strictly, after the same
    adjacency check as `load_motion_encoder_state_dict`."""
    sd = reference_state_dict(sd)
    _check_adjacency(module.motion_encoder.st_gcn.A, sd.get("motion_encoder.st_gcn.A"))
    module.load_state_dict(sd, strict=True)


# the M2SGAN generator and critic load as any module whose keys are the
# reference's (`models.generator`)
load_generator_state_dict = load_discriminator_state_dict = load_reference_state_dict


def load_music_encoder_from_m2snet(generator: nn.Module, sd) -> None:
    """Transfer a stage-1 M2SNet's music encoder (its ``music_encoder.*``
    parameters and BatchNorm statistics) into ``generator.music_encoder``,
    strictly."""
    prefix = "music_encoder."
    sd = {k[len(prefix):]: v for k, v in reference_state_dict(sd).items() if k.startswith(prefix)}
    generator.music_encoder.load_state_dict(sd, strict=True)


def _check_adjacency(ours: torch.Tensor, theirs: torch.Tensor | None) -> None:
    if theirs is not None and (
        theirs.shape != ours.shape or not torch.allclose(theirs.float().cpu(), ours.cpu(), atol=1e-5)
    ):
        raise ValueError("the checkpoint's ST-GCN adjacency does not match "
                         "build_adjacency('ConductorMotionX', 'uniform')")


def manifest(module: nn.Module) -> dict[str, tuple[int, ...]]:
    """The module's state-dict key -> shape manifest (the input of
    `synth_state_dict`)."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def synthetic_state_dict(module: nn.Module, seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic non-zero reference-format weights for ``module``:
    `synth_state_dict` over the module's own manifest (normal with std
    0.05, BN scales and variances from U(0.5, 1.5), the adjacency of
    `models.graph`)."""
    return synth_state_dict(manifest(module), seed=seed)


def synthetic_generator_state_dict(module: nn.Module, seed: int = 0) -> dict[str, np.ndarray]:
    """Synthetic weights for a `models.generator.Generator`:
    `synthetic_state_dict`, then the decoder's and the noise path's
    BatchNorm scales and the TCN's weight-norm gains moved to 1 + N(0,
    0.05).  `synth_state_dict` alone draws those around 0 (their keys do
    not end in ``.1.weight``), which shrinks the signal at each of them
    and leaves a motion that barely moves in time, on which the critic's
    max-pools sit on near-ties: float32 and float64 then route its
    gradient apart.  The TCN's keys under two names draw apart; the
    ``net.*`` ones load last and win (`models.tcn`)."""
    sd = synthetic_state_dict(module, seed=seed)
    for k, v in sd.items():
        if k.endswith(("weight_g", "noise_BN.weight")) or (
                k.startswith("tcn.") and k.endswith(("bn1.weight", "bn2.weight", "net.2.weight",
                                                     "net.7.weight"))):
            sd[k] = v + np.float32(1.0)
    return sd


synthetic_discriminator_state_dict = synthetic_state_dict  # the critic's need no adjusting


def synthetic_motion_encoder_state_dict(module: nn.Module, seed: int = 0) -> dict[str, np.ndarray]:
    """Synthetic weights for the frozen ST-GCN (`models.stgcn`) whose
    latents depend on the motion: `synthetic_state_dict`, then BN scales and
    edge importances moved to 1 + N(0, 0.05) and the conv weights doubled.
    `synth_state_dict` alone draws the ST-GCN's BN scales (``data_bn``,
    ``tcn.0``, ``tcn.3``) and edge importances around 0, which shrinks the
    signal ~400x per block and leaves features that do not see the input."""
    return _see_the_motion(synthetic_state_dict(module, seed=seed), "")


def synthetic_m2snet_state_dict(module: nn.Module, seed: int = 0) -> dict[str, np.ndarray]:
    """Synthetic weights for a whole `models.m2snet.M2SNet`:
    `synthetic_state_dict`, with the ``motion_encoder.*`` subtree adjusted
    as in `synthetic_motion_encoder_state_dict`, so that its latents see the
    motion."""
    return _see_the_motion(synthetic_state_dict(module, seed=seed), "motion_encoder.")


def _see_the_motion(sd: dict[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        if ".edge_importance." in k or k.endswith(("data_bn.weight", "tcn.0.weight", "tcn.3.weight")):
            sd[k] = v + np.float32(1.0)
        elif k.endswith(("gcn.conv.weight", "tcn.2.weight", "fc.0.weight")):
            sd[k] = v * np.float32(2.0)
    return sd
